"""Optimal hierarchical clustering with automatic cluster-count selection.

Counterpart of `sharp_tpu/ops/select.py` (`opt_hclust`, `get_opt_hclust`),
the reference's `get_opt_hclust` (R/get_opt_hclust.R:33-244): Ward linkage
over a Pearson (or 1-S) distance, a sweep of candidate cuts k in
[minN, maxN], and the rule chain:

  1. max *median* silhouette, exact ties broken by the middle tied index
     (R/get_opt_hclust.R:162-168); near ties (within SIL_TIE_EPS) re-ranked
     by the height gap under each cut (PARITY.md deviation 8);
  2. if max silhouette <= sil.thre: argmax CH index (:194-195);
  3. if CH picks the smallest k: the dendrogram height-gap rule (:196-210);
  4. a fixed `N_cluster` overrides the choice (:90-107).

For ward.D the linkage (serial Ward, or the reciprocal-NN ladder with its
tail kernel) and the cut replay go through the hand-written kernels'
wrappers (`ops/linkage_cuda.py`): on a CUDA tensor they launch the
kernels, on a CPU tensor they run the plain loops.

`opt_hclust` and `select_cut` take a leading lane axis, as the JAX package
vmaps `opt_hclust` over a block's members, a group's folds and a bucket's
blocks; `n_real`, `maxN` and `N_cluster` may differ by lane and are read
on the device only.

`gethclust`, the reference's legacy export (R/getrowColor.R:134-218),
clusters a precomputed distance through serial Ward and the cut replay at
every size, with the silhouette rule and the CH fallback only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sharp_tpu_torch.config import pad_dim
from sharp_tpu_torch.ops.distance import (
    PAD_PAD_DIST,
    _unit_rows,
    pearson_distance,
    similarity_to_distance,
    standardize_rows,
)
from sharp_tpu_torch.ops.linkage import (
    CutForest,
    LinkageResult,
    counts_per_problem,
    real_heights_tail,
    resolve_linkage_backend,
    ward_linkage,
    ward_linkage_rnn,
)
from sharp_tpu_torch.ops.linkage_cuda import cutree_multi_kernel, ward_linkage_serial
from sharp_tpu_torch.ops.silhouette import sweep_scores_nested
from sharp_tpu_torch.utils.timers import host_read, sub

_NEG = float("-inf")
SIL_TIE_EPS = 1e-4


class OptHclust(NamedTuple):
    """One problem's selection, or L problems' with a leading lane axis."""

    labels: torch.Tensor      # ([L,] n_pad) int32 dense ids in [0, k); pads at nc_pad-1
    k: torch.Tensor           # ([L]) int32 chosen cluster count
    maxsil: torch.Tensor      # ([L]) f32 max median silhouette over the sweep
    msil: torch.Tensor        # ([L,] ncand) f32 per-candidate median silhouette
    ch: torch.Tensor          # ([L,] ncand) f32 per-candidate CH index
    oind: torch.Tensor        # ([L]) int64 chosen candidate index
    heights: torch.Tensor     # ([L,] n_pad - 1) f32 merge heights
    all_labels: torch.Tensor  # ([L,] ncand, n_pad) labels of every candidate cut
    valid: torch.Tensor       # ([L,] ncand) bool — candidate is testable


def _general_linkage(D: torch.Tensor, hmethod: str) -> LinkageResult:
    """Any reference hmethod through the plain full-argmin loop. ward.D2
    runs the recurrence on squared distances and reports sqrt heights (R
    hclust semantics); the structural pad tiers are not squared."""
    if hmethod == "ward.D2":
        D2 = torch.where(D >= PAD_PAD_DIST, D, D * D)
        link = ward_linkage(D2, method="ward.D")
        return LinkageResult(link.merges, torch.sqrt(torch.clamp_min(link.heights, 0.0)))
    return ward_linkage(D, method=hmethod)


def linkage(D: torch.Tensor, backend: str, hmethod: str) -> LinkageResult:
    """Linkage of D (..., n, n) for a resolved backend ("serial" |
    "serial_bf16" | "rnn" | "rnn_bf16" | "plain",
    `ops.linkage.resolve_linkage_backend`)."""
    if backend in ("serial", "serial_bf16"):
        store = torch.bfloat16 if backend == "serial_bf16" else torch.float32
        with sub("ward_serial"):
            return ward_linkage_serial(D, store_dtype=store)
    if backend in ("rnn", "rnn_bf16"):
        store = torch.bfloat16 if backend == "rnn_bf16" else None
        return ward_linkage_rnn(D, store_dtype=store)
    return _general_linkage(D, hmethod)


def _middle_tied_argmax(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Index of the middle element among ties for the maximum of each row
    of x (..., ncand) (R: tmp[ceiling(length(tmp)/2)],
    R/get_opt_hclust.R:162-168)."""
    xm = torch.where(valid, x, _NEG)
    tied = (xm == xm.amax(dim=-1, keepdim=True)) & valid
    target = (tied.sum(dim=-1, keepdim=True) + 1) // 2
    csum = torch.cumsum(tied.to(torch.int32), dim=-1)
    return torch.argmax((csum >= target).to(torch.int32), dim=-1)


def prep_distance(mat: torch.Tensor, real_mask: torch.Tensor, symmetric: bool):
    """(D with pad tiers, D_real with pads and diagonal zeroed, feats_unit)
    for one problem or a batch (..., n_pad, .); real_mask (n_pad,) for all
    problems or (..., n_pad) one per problem."""
    if symmetric:
        D = similarity_to_distance(mat, real_mask)
        feats = mat  # CH uses S itself as features (R/get_opt_hclust.R:111,144)
    else:
        Z = standardize_rows(mat, real_mask)
        D = pearson_distance(Z, real_mask)
        feats = Z
    n = D.shape[-1]
    keep = real_mask[..., :, None] & real_mask[..., None, :]
    keep = keep & ~torch.eye(n, dtype=torch.bool, device=D.device)
    D_real = torch.where(keep, D, 0.0)
    feats_unit = _unit_rows(feats) * real_mask[..., :, None].to(torch.float32)
    return D, D_real, feats_unit


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[l, idx[l]] for every lane l of x (L, m, ...) and idx (L,)."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def select_cut(
    D_real: torch.Tensor,
    feats_unit: torch.Tensor,
    link: LinkageResult,
    cuts: CutForest,
    real_mask: torch.Tensor,
    n_real,
    maxN,
    *,
    minN: int,
    ncand: int,
    nc_pad: int,
    sil_thre: float,
    height_Ntimes: float,
    N_cluster=None,
    height_tail: int,
) -> OptHclust:
    """Score every candidate cut of L lanes and apply the rule chain to
    each: D_real (L, n, n), feats_unit (L, n, p), link and cuts with the
    lane axis, real_mask (L, n) or (n,); n_real, maxN and N_cluster (None,
    or the fixed cut) an int or one per lane (a tensor, read on the
    device). The chain is `torch.where` over the lanes, as the JAX package's
    vmapped `opt_hclust` has it: nothing is read back to the host."""
    dev = D_real.device
    L = D_real.shape[0]
    nr = counts_per_problem(n_real, L, dev).long()
    msil, ch = sweep_scores_nested(
        D_real, feats_unit, link.merges, cuts.labels, real_mask, nr, maxN,
        minN=minN, ncand=ncand, nc_pad=nc_pad,
    )
    valid = cuts.valid
    heights = link.heights
    m = heights.shape[-1]
    nr1 = nr[:, None]

    # --- rule 1: middle-tied max median silhouette, with the height-gap
    # re-rank of NEAR ties (the median saturates on near-duplicate points;
    # candidates within SIL_TIE_EPS of the max are ranked by the ratio of
    # the first refused merge height to the last accepted one) ---
    msil_v = torch.where(valid, msil, _NEG)
    maxsil = msil_v.amax(dim=-1)
    near = valid & (msil_v >= maxsil[:, None] - SIL_TIE_EPS)
    n_near = near.sum(dim=-1)
    ks_cand = minN + torch.arange(ncand, device=dev)
    midx = torch.arange(m, device=dev)
    h_next = torch.gather(heights, 1, torch.clamp(nr1 - ks_cand, 0, m - 1))
    h_last = torch.where(
        ks_cand >= nr1, 0.0, torch.gather(heights, 1, torch.clamp(nr1 - ks_cand - 1, 0, m - 1))
    )
    h_scale = torch.where(midx < nr1 - 1, heights, 0.0).amax(dim=-1, keepdim=True)
    gap_eps = torch.clamp_min(1e-6 * h_scale, 1e-12)
    gap_ratio = (h_next + gap_eps) / (torch.clamp_min(h_last, 0.0) + gap_eps)
    sil_oind = torch.where(
        n_near > 1,
        torch.argmax(torch.where(near, gap_ratio, _NEG), dim=-1),
        _middle_tied_argmax(msil, valid),
    )

    # --- rule 2: CH fallback ---
    ch_oind = torch.argmax(torch.where(valid, ch, _NEG), dim=-1)

    # --- rule 3: height-gap fallback (only if CH picked the first candidate) ---
    tailh, tail_valid = real_heights_tail(heights, nr, tail=height_tail)
    succ = tailh[:, 1:]
    pred = tailh[:, :-1]
    flag = ((succ - pred) > (height_Ntimes - 1.0) * pred) & tail_valid[:, 1:]
    pind = torch.argmax(flag.to(torch.int32), dim=-1)
    opth = 0.5 * (_take(pred, pind) + _take(succ, pind))
    # clusters after cutting at height opth: n_real - #{real merges with h <= opth}
    below = ((heights <= opth[:, None]) & (midx < nr1 - 1)).sum(dim=-1)
    hg_oind = torch.clamp(nr - below - minN, 0, ncand - 1)

    use_ch = maxsil <= sil_thre
    hg_applies = use_ch & (ch_oind == 0) & flag.any(dim=-1)
    oind = torch.where(use_ch, torch.where(hg_applies, hg_oind, ch_oind), sil_oind)
    if N_cluster is not None:
        oind = torch.clamp(counts_per_problem(N_cluster, L, dev).long() - minN, 0, ncand - 1)

    return OptHclust(
        labels=_take(cuts.labels, oind),
        k=_take(cuts.k, oind),
        maxsil=maxsil,
        msil=msil,
        ch=ch,
        oind=oind,
        heights=heights,
        all_labels=cuts.labels,
        valid=valid,
    )


def opt_hclust(
    mat: torch.Tensor,
    real_mask: torch.Tensor,
    n_real,
    maxN,
    *,
    symmetric: bool,
    minN: int,
    ncand: int,
    nc_pad: int,
    sil_thre: float = 0.35,
    height_Ntimes: float = 2.0,
    N_cluster=None,
    height_tail: int = 10,
    precomputed_link=None,
    hmethod: str = "ward.D",
    linkage_backend: str = "auto",
) -> OptHclust:
    """Cluster `mat` ((n_pad, p) features or (n_pad, n_pad) similarity), or
    L problems at once with a leading lane axis (L, n_pad, .).

    real_mask is (n_pad,) or one per lane (L, n_pad); `n_real`, `maxN`
    and `N_cluster` are ints or one per lane (tensors, read on the device).
    The L linkages go to one linkage call and one cut-replay launch, the
    selection to one `select_cut`. With `N_cluster` the sweep still runs
    but the choice is forced to that candidate (R/get_opt_hclust.R:90-107).

    `precomputed_link` (a `LinkageResult`: merges ([L,] n_pad - 1, 2)
    int32 and heights ([L,] n_pad - 1) float32 on mat's device, with the
    lane axis where mat has one) takes the place of the linkage call, as
    in the JAX package; the cut replay and the selection still run.
    """
    squeeze = mat.dim() == 2
    if squeeze:
        mat = mat[None]
    real_mask = real_mask.expand(mat.shape[0], real_mask.shape[-1])
    backend = resolve_linkage_backend(linkage_backend, real_mask.shape[-1], hmethod)
    with sub("distance"):
        D, D_real, feats_unit = prep_distance(mat, real_mask, symmetric)
    if precomputed_link is None:
        with sub("linkage"):
            link = linkage(D.contiguous(), backend, hmethod)
    else:
        link = _given_link(precomputed_link, mat, squeeze)
    del D
    nr = counts_per_problem(n_real, mat.shape[0], mat.device)
    with sub("cutree"):
        cuts = cutree_multi_kernel(
            link.merges, nr, real_mask, maxN, minN=minN, ncand=ncand, nc_pad=nc_pad
        )
    with sub("select"):
        res = select_cut(
            D_real, feats_unit, link, cuts, real_mask, nr, maxN,
            minN=minN, ncand=ncand, nc_pad=nc_pad, sil_thre=sil_thre,
            height_Ntimes=height_Ntimes, N_cluster=N_cluster, height_tail=height_tail,
        )
    return OptHclust(*(x[0] for x in res)) if squeeze else res


def _given_link(link, mat: torch.Tensor, squeeze: bool) -> LinkageResult:
    """`opt_hclust`'s precomputed_link, checked against mat (L, n_pad, .)
    and given the lane axis where mat had none."""
    L, n = mat.shape[0], mat.shape[1]
    lead = () if squeeze else (L,)
    merges, heights = link
    if (tuple(merges.shape) != (*lead, n - 1, 2) or tuple(heights.shape) != (*lead, n - 1)
            or merges.device != mat.device or heights.device != mat.device):
        raise ValueError(
            f"precomputed_link takes merges {(*lead, n - 1, 2)} and heights {(*lead, n - 1)} on "
            f"{mat.device}, got {tuple(merges.shape)} and {tuple(heights.shape)} on {merges.device}"
        )
    return LinkageResult(merges[None], heights[None]) if squeeze else LinkageResult(merges, heights)


def _pad_problem(mat: np.ndarray, symmetric: bool):
    n = mat.shape[0]
    npad = pad_dim(n)
    mask = np.zeros(npad, bool)
    mask[:n] = True
    if symmetric:
        Mp = np.zeros((npad, npad), np.float32)
        Mp[:n, :n] = mat
    else:
        Mp = np.zeros((npad, mat.shape[1]), np.float32)
        Mp[:n] = mat
    return Mp, mask, n


def get_opt_hclust(
    mat,
    hmethod: str = "ward.D",
    minN: int = 2,
    maxN: int = 40,
    sil_thre: float = 0.35,
    height_Ntimes: float = 2.0,
    N_cluster=None,
    flashmark: bool = False,
    *,
    device="cuda",
):
    """Public clustering kernel ~ reference `get_opt_hclust`
    (R/get_opt_hclust.R:33-244), numpy in and out.

    `mat` is a feature matrix (cells x p; Pearson distance) or a symmetric
    similarity matrix (d = 1 - S), detected like the reference's
    isSymmetric. Returns the reference's fields: f (1-based labels), v (all
    candidate cuts), maxsil, msil, CHind, height, optN_cluster, plus oind.
    `flashmark` is accepted for signature parity and ignored.
    """
    from sharp_tpu_torch.api import resolve_device

    dev = resolve_device(device)
    mat = np.asarray(mat, np.float32)
    symmetric = (
        mat.ndim == 2
        and mat.shape[0] == mat.shape[1]
        and np.allclose(mat, mat.T, atol=1e-6)
    )
    Mp, mask, n = _pad_problem(mat, symmetric)
    maxN = int(min(maxN, n - 1))
    ncand = max(maxN - minN + 1, 1)
    nc_pad = ((min(maxN, 40) + 9) // 8) * 8
    res = opt_hclust(
        torch.from_numpy(Mp).to(dev), torch.from_numpy(mask).to(dev), n, maxN,
        symmetric=symmetric, minN=minN, ncand=ncand, nc_pad=nc_pad,
        sil_thre=sil_thre, height_Ntimes=height_Ntimes,
        N_cluster=N_cluster, hmethod=hmethod,
    )
    site = "select.get_opt_hclust"
    return {
        "f": host_read(res.labels, site).numpy()[:n] + 1,
        "v": host_read(res.all_labels, site).numpy()[:, :n] + 1,
        "maxsil": float(host_read(res.maxsil, site)),
        "msil": host_read(res.msil, site).numpy(),
        "CHind": host_read(res.ch, site).numpy(),
        "height": host_read(res.heights, site).numpy()[: n - 1],
        "optN_cluster": int(host_read(res.k, site)),
        "oind": int(host_read(res.oind, site)),
    }


def gethclust(d, my, *, device="cuda"):
    """Legacy exported kernel ~ reference `gethclust` (R/getrowColor.R:134-218),
    numpy in and out: fixed ward.D over a precomputed distance, candidate
    cuts k = 2..min(40, n-1), middle-tied max median silhouette with the CH
    fallback at maxsil <= 0.35, and no height-gap rule.

    d: (n, n) distance matrix. my: (n, p) feature matrix for the CH index
    ("1-corr" variant). Returns the reference's fields f (1-based labels),
    maxsil, msil, CHind, height, plus oind. As in the JAX package the
    linkage is serial Ward at every size.
    """
    from sharp_tpu_torch.api import resolve_device
    from sharp_tpu_torch.ops.distance import PAD_REAL_DIST

    dev = resolve_device(device)
    d = np.asarray(d, np.float32)
    my = np.asarray(my, np.float32)
    n = d.shape[0]
    npad = pad_dim(n)
    mask = np.arange(npad) < n
    Dp = np.full((npad, npad), PAD_PAD_DIST, np.float32)
    Dp[:n, :n] = d
    Dp[:n, n:] = PAD_REAL_DIST
    Dp[n:, :n] = PAD_REAL_DIST
    np.fill_diagonal(Dp, 0.0)
    D_real = np.where(np.outer(mask, mask), Dp, 0.0).astype(np.float32)
    np.fill_diagonal(D_real, 0.0)
    Myp = np.zeros((npad, my.shape[1]), np.float32)
    Myp[:n] = my

    maxN = min(40, n - 1)
    minN = 2
    ncand = max(maxN - minN + 1, 1)
    nc_pad = ((maxN + 9) // 8) * 8
    mask_t = torch.from_numpy(mask).to(dev)
    link = linkage(torch.from_numpy(Dp).to(dev), "serial", "ward.D")
    cuts = cutree_multi_kernel(
        link.merges, n, mask_t, maxN, minN=minN, ncand=ncand, nc_pad=nc_pad
    )
    feats_unit = _unit_rows(torch.from_numpy(Myp).to(dev)) * mask_t[:, None].to(torch.float32)
    msil, ch = sweep_scores_nested(
        torch.from_numpy(D_real).to(dev), feats_unit, link.merges, cuts.labels, mask_t, n, maxN,
        minN=minN, ncand=ncand, nc_pad=nc_pad,
    )
    valid = cuts.valid
    site = "select.gethclust"
    maxsil = float(host_read(torch.where(valid, msil, _NEG).max(), site))
    if maxsil <= 0.35:
        oind = int(host_read(torch.argmax(torch.where(valid, ch, _NEG)), site))
    else:
        oind = int(host_read(_middle_tied_argmax(msil, valid), site))
    return {
        "f": host_read(cuts.labels[oind], site).numpy()[:n] + 1,
        "maxsil": maxsil,
        "msil": host_read(msil, site).numpy(),
        "CHind": host_read(ch, site).numpy(),
        "height": host_read(link.heights, site).numpy()[: n - 1],
        "oind": oind,
    }
