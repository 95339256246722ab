"""Ensemble clustering of one block or of a group of folds: project K ways,
cluster each.

Counterpart of `sharp_tpu/core/block.py`. The reference's per-RP worker
(R/SHARP.R:554-618: log2, dense RP product, get_opt_hclust) becomes one
function over written-out fold and ensemble axes: one product projects all
G folds for all K members, the G*K distance matrices are built in one
batch, the G*K linkages go to one linkage call (one serial Ward launch, or
one ladder whose rounds and tail kernel serve every lane) and the G*K cut
replays to the replay kernel in one launch; the G*K selections (the
candidate sweep and the rule chain) run in one `select_cut`, as the JAX
package vmaps `opt_hclust` over the members.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sharp_tpu_torch.ops.linkage import counts_per_problem, resolve_linkage_backend
from sharp_tpu_torch.ops.linkage_cuda import cutree_multi_kernel
from sharp_tpu_torch.ops.rp import rp_project_ensemble
from sharp_tpu_torch.ops.select import linkage, prep_distance, select_cut
from sharp_tpu_torch.utils.timers import sub


class BlockEnsembleResult(NamedTuple):
    labels: torch.Tensor     # ([G,] n_pad, K) dense per-member labels; pads at nc_pad-1
    k_per: torch.Tensor      # ([G,] K) chosen cluster count per member
    maxsil: torch.Tensor     # ([G,] K) max median silhouette per member
    mean_proj: torch.Tensor  # ([G,] n_pad, p) ensemble-mean projected features (viE block)


def cluster_block_ensemble(
    X: torch.Tensor,            # ([G,] n_pad, genes) raw (not log) expression
    real_mask: torch.Tensor,    # ([G,] n_pad) bool
    n_real,                     # int, or one per fold with a fold axis (ints or a tensor)
    R_all: torch.Tensor,        # (genes, K*p) stacked ensemble RP matrix
    maxN: int,
    log_transform: bool,
    *,
    K: int,
    minN: int = 2,
    ncand: int = 39,
    nc_pad: int = 48,
    sil_thre: float = 0.35,
    height_Ntimes: float = 2.0,
    indN_cluster: Optional[int] = None,
    linkage_backend: str = "auto",
    hmethod: str = "ward.D",
    height_tail: int = 10,
) -> BlockEnsembleResult:
    """Cluster one block (n_pad, genes), or G folds (G, n_pad, genes) with
    their masks (G, n_pad) and real counts, K ways each; the results carry
    the same leading fold axis."""
    folded = X.dim() == 3
    Xf = X if folded else X[None]
    masks = real_mask if folded else real_mask[None]
    nreal = counts_per_problem(n_real, Xf.shape[0], X.device)
    G, n_pad, genes = Xf.shape
    maxN = int(maxN)

    with sub("rp"):
        # the whole RP stage, log2 included, in one call through the
        # module's global, which a caller may wrap
        proj = rp_project_ensemble(
            Xf.reshape(G * n_pad, genes), R_all, K=K, log_transform=log_transform
        )                                                                  # (K, G*n_pad, p)
    p = proj.shape[-1]
    proj = proj.reshape(K, G, n_pad, p).transpose(0, 1)                     # (G, K, n_pad, p)
    proj = proj * masks[:, None, :, None].to(proj.dtype)
    lane_mask = masks.repeat_interleave(K, dim=0)                           # (G*K, n_pad)
    lane_nreal = nreal.repeat_interleave(K)

    backend = resolve_linkage_backend(linkage_backend, n_pad, hmethod)
    with sub("distance"):
        D, D_real, feats_unit = prep_distance(proj.reshape(G * K, n_pad, p), lane_mask, symmetric=False)
    with sub("linkage"):
        link = linkage(D.contiguous(), backend, hmethod)       # one call for all lanes
    del D
    with sub("cutree"):
        cuts = cutree_multi_kernel(                            # one launch for all lanes
            link.merges, lane_nreal, lane_mask, maxN, minN=minN, ncand=ncand, nc_pad=nc_pad
        )

    with sub("select"):
        res = select_cut(                                      # one selection for all lanes
            D_real, feats_unit, link, cuts, lane_mask, lane_nreal, maxN,
            minN=minN, ncand=ncand, nc_pad=nc_pad, sil_thre=sil_thre,
            height_Ntimes=height_Ntimes, N_cluster=indN_cluster, height_tail=height_tail,
        )
    out = BlockEnsembleResult(
        labels=res.labels.reshape(G, K, n_pad).transpose(1, 2),
        k_per=res.k.reshape(G, K),
        maxsil=res.maxsil.reshape(G, K),
        mean_proj=proj.mean(dim=1),
    )
    return out if folded else BlockEnsembleResult(*(x[0] for x in out))
