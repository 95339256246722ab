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

`gethclust`, the reference's legacy export (R/getrowColor.R:134-218),
clusters a precomputed distance through serial Ward and the cut replay at
every size, with the silhouette rule and the CH fallback only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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
    real_heights_tail,
    resolve_linkage_backend,
    ward_linkage,
    ward_linkage_rnn,
)
from sharp_tpu_torch.ops.linkage_cuda import cutree_multi_kernel, ward_linkage_serial
from sharp_tpu_torch.ops.silhouette import sweep_scores_nested

_NEG = float("-inf")
SIL_TIE_EPS = 1e-4


class OptHclust(NamedTuple):
    labels: torch.Tensor      # (n_pad,) int32 dense ids in [0, k); pads at nc_pad-1
    k: torch.Tensor           # () int32 chosen cluster count
    maxsil: torch.Tensor      # () f32 max median silhouette over the sweep
    msil: torch.Tensor        # (ncand,) f32 per-candidate median silhouette
    ch: torch.Tensor          # (ncand,) f32 per-candidate CH index
    oind: torch.Tensor        # () int64 chosen candidate index
    heights: torch.Tensor     # (n_pad - 1,) f32 merge heights
    all_labels: torch.Tensor  # (ncand, n_pad) labels of every candidate cut
    valid: torch.Tensor       # (ncand,) bool — candidate is testable


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
        return ward_linkage_serial(D, store_dtype=store)
    if backend in ("rnn", "rnn_bf16"):
        store = torch.bfloat16 if backend == "rnn_bf16" else None
        return ward_linkage_rnn(D, store_dtype=store)
    return _general_linkage(D, hmethod)


def _middle_tied_argmax(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Index of the middle element among ties for the maximum
    (R: tmp[ceiling(length(tmp)/2)], R/get_opt_hclust.R:162-168)."""
    xm = torch.where(valid, x, _NEG)
    tied = (xm == xm.max()) & valid
    target = (tied.sum() + 1) // 2
    csum = torch.cumsum(tied.to(torch.int32), dim=0)
    return torch.argmax((csum >= target).to(torch.int32))


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


def select_cut(
    D_real: torch.Tensor,
    feats_unit: torch.Tensor,
    link: LinkageResult,
    cuts: CutForest,
    real_mask: torch.Tensor,
    n_real: int,
    maxN: int,
    *,
    minN: int,
    ncand: int,
    nc_pad: int,
    sil_thre: float,
    height_Ntimes: float,
    N_cluster: Optional[int],
    height_tail: int,
) -> OptHclust:
    """Score every candidate cut of one problem and apply the rule chain."""
    dev = D_real.device
    msil, ch = sweep_scores_nested(
        D_real, feats_unit, link.merges, cuts.labels, real_mask, n_real, maxN,
        minN=minN, ncand=ncand, nc_pad=nc_pad,
    )
    valid = cuts.valid
    heights = link.heights
    m = heights.shape[0]

    # --- rule 1: middle-tied max median silhouette, with the height-gap
    # re-rank of NEAR ties (the median saturates on near-duplicate points;
    # candidates within SIL_TIE_EPS of the max are ranked by the ratio of
    # the first refused merge height to the last accepted one) ---
    msil_v = torch.where(valid, msil, _NEG)
    maxsil = msil_v.max()
    near = valid & (msil_v >= maxsil - SIL_TIE_EPS)
    n_near = int(near.sum())
    ks_cand = minN + torch.arange(ncand, device=dev)
    midx = torch.arange(m, device=dev)
    t_next = torch.clamp(n_real - ks_cand, 0, m - 1)
    t_last = torch.clamp(n_real - ks_cand - 1, 0, m - 1)
    h_next = heights[t_next]
    h_last = torch.where(ks_cand >= n_real, 0.0, heights[t_last])
    h_scale = torch.where(midx < n_real - 1, heights, 0.0).max()
    gap_eps = torch.clamp_min(1e-6 * h_scale, 1e-12)
    gap_ratio = (h_next + gap_eps) / (torch.clamp_min(h_last, 0.0) + gap_eps)
    if n_near > 1:
        sil_oind = torch.argmax(torch.where(near, gap_ratio, _NEG))
    else:
        sil_oind = _middle_tied_argmax(msil, valid)

    # --- rule 2: CH fallback ---
    ch_oind = torch.argmax(torch.where(valid, ch, _NEG))

    # --- rule 3: height-gap fallback (only if CH picked the first candidate) ---
    tailh, tail_valid = real_heights_tail(heights, n_real, tail=height_tail)
    succ = tailh[1:]
    pred = tailh[:-1]
    flag = ((succ - pred) > (height_Ntimes - 1.0) * pred) & tail_valid[1:]
    pind = torch.argmax(flag.to(torch.int32))
    opth = 0.5 * (pred[pind] + succ[pind])
    # clusters after cutting at height opth: n_real - #{real merges with h <= opth}
    below = ((heights <= opth) & (midx < n_real - 1)).sum()
    hg_oind = torch.clamp(n_real - below - minN, 0, ncand - 1)

    use_ch = bool(maxsil <= sil_thre)
    if use_ch:
        hg_applies = int(ch_oind) == 0 and bool(flag.any())
        oind = hg_oind if hg_applies else ch_oind
    else:
        oind = sil_oind
    oind = int(oind)
    if N_cluster is not None:
        oind = min(max(int(N_cluster) - minN, 0), ncand - 1)

    return OptHclust(
        labels=cuts.labels[oind],
        k=cuts.k[oind],
        maxsil=maxsil,
        msil=msil,
        ch=ch,
        oind=torch.tensor(oind),
        heights=heights,
        all_labels=cuts.labels,
        valid=valid,
    )


def opt_hclust(
    mat: torch.Tensor,
    real_mask: torch.Tensor,
    n_real: int,
    maxN: int,
    *,
    symmetric: bool,
    minN: int,
    ncand: int,
    nc_pad: int,
    sil_thre: float = 0.35,
    height_Ntimes: float = 2.0,
    N_cluster: Optional[int] = None,
    height_tail: int = 10,
    hmethod: str = "ward.D",
    linkage_backend: str = "auto",
) -> OptHclust:
    """Cluster `mat` ((n_pad, p) features or (n_pad, n_pad) similarity).

    `n_real`, `maxN` and `N_cluster` are host integers (a 0-d tensor is
    read once). With `N_cluster` the sweep still runs but the choice is
    forced to that candidate (R/get_opt_hclust.R:90-107).
    """
    n_real, maxN = int(n_real), int(maxN)
    backend = resolve_linkage_backend(linkage_backend, real_mask.shape[0], hmethod)
    D, D_real, feats_unit = prep_distance(mat, real_mask, symmetric)
    link = linkage(D.contiguous(), backend, hmethod)
    cuts = cutree_multi_kernel(
        link.merges, n_real, real_mask, maxN, minN=minN, ncand=ncand, nc_pad=nc_pad
    )
    return select_cut(
        D_real, feats_unit, link, cuts, real_mask, n_real, maxN,
        minN=minN, ncand=ncand, nc_pad=nc_pad, sil_thre=sil_thre,
        height_Ntimes=height_Ntimes, N_cluster=N_cluster, height_tail=height_tail,
    )


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
    return {
        "f": res.labels.cpu().numpy()[:n] + 1,
        "v": res.all_labels.cpu().numpy()[:, :n] + 1,
        "maxsil": float(res.maxsil),
        "msil": res.msil.cpu().numpy(),
        "CHind": res.ch.cpu().numpy(),
        "height": res.heights.cpu().numpy()[: n - 1],
        "optN_cluster": int(res.k),
        "oind": int(res.oind),
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
    maxsil = torch.where(valid, msil, _NEG).max()
    if float(maxsil) <= 0.35:
        oind = int(torch.argmax(torch.where(valid, ch, _NEG)))
    else:
        oind = int(_middle_tied_argmax(msil, valid))
    return {
        "f": cuts.labels[oind].cpu().numpy()[:n] + 1,
        "maxsil": float(maxsil),
        "msil": msil.cpu().numpy(),
        "CHind": ch.cpu().numpy(),
        "height": link.heights.cpu().numpy()[: n - 1],
        "oind": oind,
    }
