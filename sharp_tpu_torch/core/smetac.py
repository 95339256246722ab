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

from typing import NamedTuple, Optional

import torch

from sharp_tpu_torch.ops.select import opt_hclust


class SMetaCResult(NamedTuple):
    tf: torch.Tensor       # (meta slots,) meta label per fold-cluster
    n_final: int
    maxsil: torch.Tensor
    oind: int


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
    centroids: torch.Tensor,   # (NC_pad, p) fold-cluster centroids in mean-RP space
    valid: torch.Tensor,       # (NC_pad,) bool
    n_clusters: int,           # actual number of fold-clusters
    maxN: int,
    *,
    minN: int,
    ncand: int,
    meta_nc_pad: int,
    sil_thre: float = 0.35,
    height_Ntimes: float = 2.0,
    finalN_cluster: Optional[int] = None,
    hmethod: str = "ward.D",
    linkage_backend: str = "auto",
) -> SMetaCResult:
    n_clusters, maxN = int(n_clusters), int(maxN)
    # Pearson correlation of centroids (R/sMetaC.R:67-78): center rows,
    # unit-normalize, one product
    Xc = centroids - centroids.mean(dim=-1, keepdim=True)
    U = Xc * torch.rsqrt((Xc * Xc).sum(dim=-1, keepdim=True) + 1e-12)
    S = U @ U.T
    S = torch.where(torch.eye(S.shape[0], dtype=torch.bool, device=S.device), 1.0, S)

    res = opt_hclust(
        S, valid, n_clusters, min(maxN, n_clusters - 1),
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
    second_val = torch.sort(msil_valid).values[-2] if ncand > 1 else msil_valid[0]
    second_idx = int(torch.argmax((msil_valid == second_val).to(torch.int32)))
    override = (
        ncand > 1
        and int(res.k) == 2
        and bool(res.maxsil > sil_thre)
        and bool(torch.isfinite(second_val))
        and finalN_cluster is None
    )
    oind = second_idx if override else int(res.oind)
    tf = res.all_labels[oind]

    occ = torch.zeros(meta_nc_pad, dtype=torch.int32, device=tf.device)
    occ = occ.scatter_reduce(0, tf.long(), valid.to(torch.int32), reduce="amax")
    occ[meta_nc_pad - 1] = 0
    return SMetaCResult(tf=tf, n_final=int(occ.sum()), maxsil=res.maxsil, oind=oind)
