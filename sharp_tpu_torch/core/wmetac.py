"""Weighted meta-clustering (wMetaC): fuse K member labellings into one.

Counterpart of `sharp_tpu/core/wmetac.py`, the reference algorithm
(R/wMetaC.R:15-226):

  1. co-association A = mean_k [label_i == label_j]            (:24-25)
  2. entry weights a(1-a)                                      (:30-36)
  3. cell weights w0 = 4/N * rowSums, w1 = (w0+0.01)/1.01      (:41-44)
  4. member-distinct cluster ids (member k, slot c)            (:60-64)
  5. cluster-pair similarity = w1-weighted Jaccard of members  (:70-77)
  6. hierarchical meta-clustering of S via opt_hclust
     (sil.thre defaults to 0 here)                             (:94-99)
  7. per-cell majority vote over mapped member labels          (:141-143)
  8. single-cluster fallback: prefer the runner-up vote        (:147-161)
  9. visualization matrix x0: 1 at own cluster,
     0.5 * count-ratio elsewhere                               (:179-208)

The global cluster axis is compacted to `allc_pad` slots in first-index
order by a cumulative sum, with unused slots pointing at the last global
slot K*nc_pad-1 (the JAX package's `jnp.nonzero(size=allc_pad,
fill_value=K*nc_pad-1)`), so nothing is read back to the host. Slot nc_pad-1 of
every member is the reserved garbage slot of padded cells. Ties in every
argmax go to the first index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from sharp_tpu_torch.ops.linkage import counts_per_problem
from sharp_tpu_torch.ops.select import opt_hclust
from sharp_tpu_torch.utils.timers import sub


class WMetaCResult(NamedTuple):
    """One fold's consensus, or G folds' with a leading fold axis."""

    finalC: torch.Tensor    # ([G,] n_pad) int32 consensus labels in [0, n_meta); pads -> nc_pad-1
    n_meta: torch.Tensor    # ([G]) int32 number of consensus clusters
    x0: torch.Tensor        # ([G,] n_pad, nc_pad) f32 visualization matrix
    tf: torch.Tensor        # ([G,] allc_pad) meta label of each compacted member-cluster
    allC: torch.Tensor      # ([G]) int32 number of distinct member clusters
    overflow: torch.Tensor  # ([G]) bool — allc_pad budget exceeded (results degraded)


class _Similarity(NamedTuple):
    S: torch.Tensor           # (G, allc_pad, allc_pad) w1-weighted Jaccard, 1 on the diagonal
    comp_ids: torch.Tensor    # (G, allc_pad) global slot of each compacted cluster
    comp_valid: torch.Tensor  # (G, allc_pad) bool
    total_occ: torch.Tensor   # (G,) distinct member clusters before the budget cut


def _member_onehots(labels: torch.Tensor, real_mask: torch.Tensor, nc_pad: int):
    oh = F.one_hot(labels.long(), nc_pad).to(torch.float32)       # (G, n, K, nc)
    oh = oh * real_mask.to(torch.float32)[..., None, None]
    oh[..., nc_pad - 1] = 0.0
    return oh


def cluster_similarity(
    labels: torch.Tensor, real_mask: torch.Tensor, n_real, *,
    K: int, nc_pad: int, allc_pad: int,
) -> _Similarity:
    """Steps 1-5 for G folds, labels (G, n_pad, K), real_mask (G, n_pad),
    n_real (G,): co-association weights and the compacted w1-weighted
    Jaccard similarity between member clusters."""
    G, n_pad = labels.shape[:2]
    dev = labels.device
    rm = real_mask.to(torch.float32)
    oh = _member_onehots(labels, real_mask, nc_pad)
    nr = counts_per_problem(n_real, G, dev)

    # --- 1-3: co-association and cell weights ----------------------------
    flat = oh.reshape(G, n_pad, K * nc_pad)
    AA = (flat @ flat.transpose(1, 2)) / K                       # (G, n, n)
    newAA = AA * (1.0 - AA)
    w0 = (4.0 / torch.clamp_min(nr, 1).to(torch.float32))[:, None] * newAA.sum(dim=2)
    del AA, newAA
    w1 = (w0 + 0.01) / 1.01
    w1 = w1 * rm                                                  # pads weightless

    # --- 4: compact global cluster ids (g = k * nc_pad + c) in first-index
    # order; unused slots point at the last global slot --------------------
    occ_flat = (oh.sum(dim=1) > 0.5).reshape(G, K * nc_pad)       # (G, K*nc)
    total_occ = occ_flat.sum(dim=1)
    pos = torch.cumsum(occ_flat.to(torch.int64), dim=1) - 1
    dest = torch.where(occ_flat & (pos < allc_pad), pos, allc_pad)   # allc_pad: thrown away
    comp_ids = torch.full((G, allc_pad + 1), K * nc_pad - 1, dtype=torch.long, device=dev)
    comp_ids.scatter_(1, dest, torch.arange(K * nc_pad, device=dev).expand(G, -1))
    comp_ids = comp_ids[:, :allc_pad]
    comp_valid = torch.arange(allc_pad, device=dev)[None, :] < total_occ[:, None]

    # membership matrix M: (G, allc_pad, n) over real cells
    M_full = oh.permute(0, 2, 3, 1).reshape(G, K * nc_pad, n_pad)
    M = torch.gather(M_full, 1, comp_ids[..., None].expand(G, allc_pad, n_pad))
    M = M * comp_valid[..., None].to(torch.float32)

    # --- 5: w1-weighted Jaccard similarity (full float32 product) --------
    Mw = M * w1[:, None, :]
    inter = Mw @ M.transpose(1, 2)
    wsum = Mw.sum(dim=2)
    union = wsum[:, :, None] + wsum[:, None, :] - inter
    S = torch.where(
        (inter > 0) & (union > 1e-12), inter / torch.clamp_min(union, 1e-12), 0.0
    )
    S = torch.where(torch.eye(allc_pad, dtype=torch.bool, device=dev), 1.0, S)
    return _Similarity(S, comp_ids, comp_valid, total_occ)


def _count_unique(lbl: torch.Tensor, rm: torch.Tensor, nc_pad: int) -> torch.Tensor:
    occ = (F.one_hot(lbl, nc_pad).to(torch.float32) * rm[..., None]).sum(dim=1) > 0.5
    occ[:, nc_pad - 1] = False
    return occ.sum(dim=1, dtype=torch.int32)


def wmetac(
    labels: torch.Tensor,       # ([G,] n_pad, K) dense per-member labels; pads at nc_pad-1
    real_mask: torch.Tensor,    # ([G,] n_pad) bool
    n_real,                     # int, or (G,) one per fold
    maxN,                       # max clusters for the meta hclust: int, or (G,)
    *,
    K: int,
    nc_pad: int,
    allc_pad: int = 256,
    meta_minN: int = 2,
    meta_ncand: int = 39,
    sil_thre: float = 0.0,
    height_Ntimes: float = 2.0,
    enN_cluster=None,
    hmethod: str = "ward.D",
    linkage_backend: str = "auto",
) -> WMetaCResult:
    """wMetaC of one fold (labels (n_pad, K)) or of G folds at once (labels
    (G, n_pad, K)): the G meta problems go to one `opt_hclust` (one serial
    Ward launch of (G, allc_pad, allc_pad), one cut replay, one selection),
    as the JAX package vmaps `wmetac` over the folds of a group. Counts and
    the single-cluster fallback stay on the device."""
    squeeze = labels.dim() == 2
    if squeeze:
        labels, real_mask = labels[None], real_mask[None]
    G, n_pad = labels.shape[:2]
    dev = labels.device
    rm = real_mask.to(torch.float32)
    with sub("similarity"):
        sim = cluster_similarity(
            labels, real_mask, n_real, K=K, nc_pad=nc_pad, allc_pad=allc_pad
        )

    # --- 6: meta hierarchical clustering --------------------------------
    allC = torch.clamp_max(sim.total_occ, allc_pad)
    with sub("meta"):
        meta = opt_hclust(
            sim.S, sim.comp_valid, allC,
            torch.minimum(counts_per_problem(maxN, G, dev).long(), allC - 1),
            symmetric=True, minN=meta_minN, ncand=meta_ncand, nc_pad=nc_pad,
            sil_thre=sil_thre, height_Ntimes=height_Ntimes, N_cluster=enN_cluster,
            hmethod=hmethod, linkage_backend=linkage_backend,
        )
    tf = meta.labels                                              # (G, allc_pad)

    # --- 7: majority vote ------------------------------------------------
    # global slot -> compacted position; slots outside the compaction map to
    # the extra entry allc_pad, whose meta label is the garbage slot. (The
    # fill entries of comp_ids, the never-occupied garbage slot of the last
    # member, would map to padded meta slots, whose label is the garbage
    # slot as well.)
    slot = torch.arange(allc_pad, device=dev).expand(G, -1)
    inv = torch.full((G, K * nc_pad + 1), allc_pad, dtype=torch.long, device=dev)
    inv.scatter_(1, torch.where(slot < allC[:, None], sim.comp_ids, K * nc_pad), slot)
    tf_ext = torch.cat([tf.to(torch.int32), torch.full((G, 1), nc_pad - 1, dtype=torch.int32, device=dev)], 1)
    g = torch.arange(K, device=dev) * nc_pad + labels.long()      # (G, n, K)
    member_meta = torch.gather(tf_ext, 1, torch.gather(inv, 1, g.reshape(G, -1))).reshape(G, n_pad, K)

    votes_oh = F.one_hot(member_meta.long(), nc_pad).to(torch.float32)
    votes_oh[..., nc_pad - 1] = 0.0
    votes = votes_oh.sum(dim=2)                                   # (G, n, nc_pad)
    finalC = torch.argmax(votes, dim=2)

    # --- 8: single-cluster fallback (R/wMetaC.R:147-161) -----------------
    own = F.one_hot(finalC, nc_pad) > 0
    votes2 = torch.where(own, -1.0, votes)
    alt = torch.where(votes2.amax(dim=2) > 0.5, torch.argmax(votes2, dim=2), finalC)
    finalC = torch.where((_count_unique(finalC, rm, nc_pad) == 1)[:, None], alt, finalC)
    n_unique = _count_unique(finalC, rm, nc_pad)

    finalC = torch.where(real_mask, finalC, nc_pad - 1)

    # --- 9: visualization matrix x0 --------------------------------------
    own = torch.gather(votes, 2, finalC[..., None])
    x0 = torch.where(votes > 0, 0.5 * votes / torch.clamp_min(own, 1e-12), 0.0)
    x0 = torch.where(F.one_hot(finalC, nc_pad) > 0, 1.0, x0)
    x0 = x0 * rm[..., None]
    x0[..., nc_pad - 1] = 0.0

    out = WMetaCResult(
        finalC=finalC.to(torch.int32),
        n_meta=n_unique,
        x0=x0,
        tf=tf,
        allC=allC.to(torch.int32),
        overflow=sim.total_occ > allc_pad,
    )
    return WMetaCResult(*(x[0] for x in out)) if squeeze else out
