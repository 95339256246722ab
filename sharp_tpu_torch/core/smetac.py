"""Similarity-based meta-clustering (sMetaC): fusion across folds.

Counterpart of `sharp_tpu/core/smetac.py`, following R/sMetaC.R:17-209:

  1. per-cluster centroid in the shared mean-RP feature space (:58-63)
  2. pairwise Pearson correlation of centroids as similarity S (:67-85)
  3. ncells-dependent min/max cluster-range adjustment (:103-119)
  4. opt_hclust on S (:128-129)
  5. the reference's quirk, kept: if the chosen cut has exactly 2 clusters
     with silhouette above threshold, take the *second-best* silhouette
     solution instead, ranked over the valid candidates only (:139-147)

This stage only touches O(#clusters x p) data.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sharp_tpu_torch.ops.linkage import counts_per_problem
from sharp_tpu_torch.ops.select import opt_hclust


class SMetaCResult(NamedTuple):
    """One block's fuse, or B blocks' with a leading block axis."""

    tf: torch.Tensor        # ([B,] NC_pad) meta label per fold-cluster
    n_final: torch.Tensor   # ([B]) int32
    maxsil: torch.Tensor    # ([B]) f32
    oind: torch.Tensor      # ([B]) int64 chosen candidate index


def smetac_range(n_cells: int, minN: int, maxN: int, n_clusters: int):
    """The ncells-dependent search-range rules (R/sMetaC.R:103-119)."""
    if n_cells < 1e6:
        baseN = min(max(n_cells // 10000, 2), 10)
        if minN == 2 and min(maxN, n_clusters) - baseN >= 3:
            minN = baseN
    else:
        maxN = max(maxN, n_cells // 5000)
        minN = max(minN, n_cells // 50000)
    return int(minN), int(maxN)


def smetac(
    centroids: torch.Tensor,   # ([B,] NC_pad, p) fold-cluster centroids in mean-RP space
    valid: torch.Tensor,       # ([B,] NC_pad) bool
    n_clusters,                # actual number of fold-clusters: int, or (B,)
    maxN,                      # int, or (B,)
    *,
    minN: int,
    ncand: int,
    meta_nc_pad: int,
    sil_thre: float = 0.35,
    height_Ntimes: float = 2.0,
    finalN_cluster=None,
    hmethod: str = "ward.D",
    linkage_backend: str = "auto",
) -> SMetaCResult:
    """sMetaC of one block, or of B blocks of one shape at once (one
    `opt_hclust` over B lanes, as the JAX package vmaps `smetac` over a
    shape bucket). Everything stays on the device."""
    squeeze = centroids.dim() == 2
    if squeeze:
        centroids, valid = centroids[None], valid[None]
    B, NC_pad = valid.shape
    dev = centroids.device
    nc = counts_per_problem(n_clusters, B, dev).long()
    # Pearson correlation of centroids (R/sMetaC.R:67-78): center rows,
    # unit-normalize, one product
    Xc = centroids - centroids.mean(dim=-1, keepdim=True)
    U = Xc * torch.rsqrt((Xc * Xc).sum(dim=-1, keepdim=True) + 1e-12)
    S = U @ U.transpose(1, 2)
    S = torch.where(torch.eye(NC_pad, dtype=torch.bool, device=dev), 1.0, S)

    res = opt_hclust(
        S, valid, nc, torch.minimum(counts_per_problem(maxN, B, dev).long(), nc - 1),
        symmetric=True, minN=minN, ncand=ncand, nc_pad=meta_nc_pad,
        sil_thre=sil_thre, height_Ntimes=height_Ntimes, N_cluster=finalN_cluster,
        hmethod=hmethod, linkage_backend=linkage_backend,
    )

    # --- second-best-silhouette override (R/sMetaC.R:139-147) ------------
    # R's sort(partial)[n-1] counts duplicates: the second-largest value
    # including ties, then the first index holding it; invalid cuts never win
    msil_valid = torch.where(
        res.valid & torch.isfinite(res.msil), res.msil, float("-inf")
    )
    second_val = torch.sort(msil_valid, dim=-1).values[:, -2] if ncand > 1 else msil_valid[:, 0]
    second_idx = torch.argmax((msil_valid == second_val[:, None]).to(torch.int32), dim=-1)
    override = (
        (res.k == 2) & (res.maxsil > sil_thre) & torch.isfinite(second_val)
        & (ncand > 1 and finalN_cluster is None)
    )
    oind = torch.where(override, second_idx, res.oind)
    tf = res.all_labels[torch.arange(B, device=dev), oind]

    occ = torch.zeros((B, meta_nc_pad), dtype=torch.int32, device=dev)
    occ = occ.scatter_reduce(1, tf.long(), valid.to(torch.int32), reduce="amax")
    occ[:, meta_nc_pad - 1] = 0
    out = SMetaCResult(tf=tf, n_final=occ.sum(dim=1, dtype=torch.int32), maxsil=res.maxsil, oind=oind)
    return SMetaCResult(*(x[0] for x in out)) if squeeze else out
