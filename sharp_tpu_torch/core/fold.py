"""The per-fold program: ensemble cluster + wMetaC + centroid summary.

Counterpart of `sharp_tpu/core/fold.py`. A fold exports only O(clusters x
p) summary data (labels, centroid sums, counts, x0 votes): the cross-fold
merge traffic of the reference's design (SURVEY.md §5.7). The program
takes a group of G folds at once: one ensemble call covers the G*K members
(one projection, one linkage call, one cut-replay launch, one selection),
then wMetaC covers the G folds in one call (one serial Ward launch of G
meta problems), as the JAX package vmaps its fold program over a group.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from sharp_tpu_torch.config import SharpConfig
from sharp_tpu_torch.core.block import BlockEnsembleResult, cluster_block_ensemble
from sharp_tpu_torch.core.wmetac import wmetac
from sharp_tpu_torch.ops.linkage import counts_per_problem
from sharp_tpu_torch.utils.timers import span, sub


class FoldSummary(NamedTuple):
    finalC: torch.Tensor     # ([G,] B) fold-local consensus labels; pads at nc_pad-1
    n_meta: torch.Tensor     # ([G]) int32
    cent_sum: torch.Tensor   # ([G,] nc_pad, p) per-cluster centroid sums in mean-RP space
    counts: torch.Tensor     # ([G,] nc_pad)
    mean_proj: torch.Tensor  # ([G,] B, p)
    x0: torch.Tensor         # ([G,] B, nc_pad)
    k_per: torch.Tensor      # ([G,] K)
    maxsil: torch.Tensor     # ([G,] K)
    overflow: torch.Tensor   # ([G]) bool — wMetaC allc_pad budget exceeded (degraded consensus)


def _allc_pad(cfg: SharpConfig) -> int:
    """Static budget for distinct (member, cluster) ids in wMetaC."""
    exact = cfg.ensize_K * min(cfg.maxN_cluster + 1, cfg.nc_pad - 1)
    return min(max(64, ((exact + 63) // 64) * 64), 1024)


def fold_static_args(cfg: SharpConfig) -> dict:
    maxN = min(cfg.maxN_cluster, 40)
    return dict(
        K=cfg.ensize_K,
        minN=cfg.minN_cluster,
        ncand=maxN - cfg.minN_cluster + 1,
        nc_pad=cfg.nc_pad,
        allc_pad=_allc_pad(cfg),
        sil_thre=cfg.sil_thre,
        height_Ntimes=cfg.height_Ntimes,
        maxN=maxN,
        linkage_backend=cfg.linkage_backend,
        hmethod=cfg.hmethod,
    )


def fold_program(
    X: torch.Tensor,                       # ([G,] B, genes)
    mask: torch.Tensor,                    # ([G,] B) bool
    n_real: Union[int, Sequence[int]],     # one per fold with a fold axis
    R_all: torch.Tensor,                   # (genes, K*p)
    log_transform: bool,
    indN_cluster: Optional[int] = None,
    *,
    K: int,
    minN: int,
    ncand: int,
    nc_pad: int,
    allc_pad: int,
    sil_thre: float,
    height_Ntimes: float,
    maxN: int,
    has_indN: bool = False,
    linkage_backend: str = "auto",
    hmethod: str = "ward.D",
) -> FoldSummary:
    """The fold program of one fold X (B, genes) or a group of G folds
    (G, B, genes). `indN_cluster` fixes every member's cluster count only
    when `has_indN` is true, as in the JAX package
    (sharp_tpu/core/fold.py:91); otherwise each member picks its own."""
    folded = X.dim() == 3
    Xf = X if folded else X[None]
    masks = mask if folded else mask[None]
    with span("fold"):
        # the real counts go to the device once, before any work is queued
        nreal = counts_per_problem(n_real if folded else [n_real], Xf.shape[0], Xf.device)
        blk = cluster_block_ensemble(
            Xf, masks, nreal, R_all, maxN, log_transform,
            K=K, minN=minN, ncand=ncand, nc_pad=nc_pad,
            sil_thre=sil_thre, height_Ntimes=height_Ntimes,
            indN_cluster=indN_cluster if has_indN else None, linkage_backend=linkage_backend,
            hmethod=hmethod,
        )
        out = fold_summary(
            blk, masks, nreal, K=K, minN=minN, ncand=ncand, nc_pad=nc_pad, allc_pad=allc_pad,
            height_Ntimes=height_Ntimes, maxN=maxN, linkage_backend=linkage_backend, hmethod=hmethod,
        )
    return out if folded else FoldSummary(*(x[0] for x in out))


def fold_summary(
    blk: BlockEnsembleResult,      # (G, B, K) labels and the rest, G folds
    masks: torch.Tensor,           # (G, B) bool
    nreal,                         # (G,) int32 on the device, or G ints
    *,
    K: int,
    minN: int,
    ncand: int,
    nc_pad: int,
    allc_pad: int,
    height_Ntimes: float,
    maxN: int,
    linkage_backend: str = "auto",
    hmethod: str = "ward.D",
) -> FoldSummary:
    """wMetaC of a group's G folds in one call, and the fold summaries
    (batched over the group). The mesh's ensemble split
    (`parallel/sharded.py`) gathers its shards' members into `blk` first."""
    with sub("wmetac"):
        wres = wmetac(
            blk.labels, masks, nreal, maxN,
            K=K, nc_pad=nc_pad, allc_pad=allc_pad,
            meta_minN=minN, meta_ncand=ncand,
            sil_thre=0.0, height_Ntimes=height_Ntimes,
            hmethod=hmethod, linkage_backend=linkage_backend,
        )
    oh = F.one_hot(wres.finalC.long(), nc_pad).to(torch.float32)
    oh = oh * masks[..., None].to(torch.float32)
    return FoldSummary(
        finalC=wres.finalC, n_meta=wres.n_meta, cent_sum=oh.transpose(1, 2) @ blk.mean_proj,
        counts=oh.sum(dim=1), mean_proj=blk.mean_proj, x0=wres.x0, k_per=blk.k_per,
        maxsil=blk.maxsil, overflow=wres.overflow,
    )
