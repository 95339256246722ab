"""Plain reference of SHARP's large tier on one block: the fold partition,
the cells taken in the permutation's order, each fold's ensemble and
wMetaC, the fold summaries, the sMetaC fuse over the block's folds, the
un-permute and the final relabelling.

Written from SHARP's R/SHARP.R:478-851 (SHARP_large), composing the
pieces of `meta.py` and `cluster.py`; imports torch and numpy only, and
nothing of the program under test. Float32, TF32 off where the caller
holds `cluster.full_float32()`. Departures from R/SHARP.R:

  * the cell reshuffle (:493-507) and the K RP matrices (:541-549) are
    inputs (`perm`, `R`), the draws the program was handed;
  * log2(1 + x) is applied unconditionally: the reference's rule at and
    above 1e4 cells (:202-228), the only case the callers use;
  * each fold runs `meta.fold`'s steps spelt out (projection, distances,
    members' Ward and cut choice, wMetaC), to keep each member's chosen
    k, which `meta.fold` does not return;
  * a fold's summary (:733-746) is the centroid SUMS of its ensemble-mean
    projection over its wMetaC labels, in `nc_pad` slots, and the counts;
    sMetaC divides them, as the ports do;
  * the sMetaC fuse is `meta.fuse_block` at the block's own cell count
    (:747-773), and the end is `meta.finalize` with the tiny-cluster merge
    above 1e4 cells (:775-843);
  * `prefer`, the program's answer, picks among the choices the
    reference's rounding cannot tell apart (`meta._closest`,
    `cluster.choose`): each member's k from the program's per-member k;
    a fold's consensus and the fuse's partition from the program's final
    labels, the closest of the admissible ones (the program's fold
    consensus itself is not among its outputs).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from perfbench.data.atlas import fold_sizes
from perfbench.reference import meta
from perfbench.reference.cluster import opt_hclust, pearson_distance, project
from perfbench.reference.meta import allc_pad, nc_pad


class LargeRef(NamedTuple):
    labels: np.ndarray     # (n,) final labels 1..C, in the caller's cell order
    folds: np.ndarray      # (n,) each cell's fold
    viE: np.ndarray        # (n, p) each cell's fold ensemble-mean projection
    k_per: np.ndarray      # (T, K) each member's chosen cluster count
    maxsil: np.ndarray     # (T, K) each member's max median silhouette


def config(n_cells: int, K: int, *, p: Optional[int] = None, partition_ncells: int = 2000,
           rp_kind: str = "float32", minN: int = 2, maxN_cluster: Optional[int] = None,
           sil_thre: float = 0.35, height_Ntimes: float = 2.0) -> dict:
    """SHARP's knobs for a block of n_cells (R/SHARP.R:119-228) as `meta`'s
    functions read them: p = ceil(log2(n) / 0.04), maxN = max(40,
    ceil(n / 5000)), candidates minN..min(maxN, 40)."""
    maxN_cluster = maxN_cluster or max(40, math.ceil(n_cells / 5000))
    maxN = min(maxN_cluster, 40)
    return dict(K=K, p=p or math.ceil(math.log2(max(n_cells, 2)) / 0.04), partition_ncells=partition_ncells,
                rp_kind=rp_kind, mm_kind="float32", minN=minN, maxN=maxN, ncand=maxN - minN + 1,
                nc_cap=nc_pad(maxN_cluster) - 1, sil_thre=sil_thre, height_Ntimes=height_Ntimes,
                sim_width=allc_pad(K, maxN_cluster), n_cells=n_cells, maxN_cluster=maxN_cluster,
                nc_pad=nc_pad(maxN_cluster))


def fold(X: torch.Tensor, R: torch.Tensor, cfg: dict, prefer: Optional[dict] = None):
    """One fold of cells X (n, genes), log2 applied -> (its summary for
    `meta.fuse_block`: finalC, cent_sum (nc_pad, p), counts (nc_pad,);
    the ensemble-mean projection (n, p); each member's k (K,); each
    member's max silhouette (K,))."""
    prefer = prefer or {}
    proj = project(X, R, cfg["K"], True, cfg["rp_kind"])                  # (K, n, p)
    res = opt_hclust(pearson_distance(proj, cfg["mm_kind"]), proj, minN=cfg["minN"], ncand=cfg["ncand"],
                     maxN=cfg["maxN"], nc_cap=cfg["nc_cap"], sil_thre=cfg["sil_thre"],
                     height_Ntimes=cfg["height_Ntimes"], prefer_k=prefer.get("k_per"))
    finalC = meta.wmetac(res["labels"].T, maxN=cfg["maxN"], minN=cfg["minN"], ncand=cfg["ncand"],
                         nc_cap=cfg["nc_cap"], sim_width=cfg["sim_width"], height_Ntimes=cfg["height_Ntimes"],
                         prefer=prefer.get("finalC"))
    mean_proj = proj.mean(dim=0)
    lab = torch.as_tensor(finalC, dtype=torch.long, device=X.device)
    width = cfg["nc_pad"]
    sums = torch.zeros((width, mean_proj.shape[1]), dtype=torch.float64, device=X.device)
    sums.index_add_(0, lab, mean_proj.double())
    summary = dict(finalC=finalC, cent_sum=sums.float().cpu().numpy(),
                   counts=torch.bincount(lab, minlength=width).float().cpu().numpy())
    return summary, mean_proj.cpu().numpy(), np.asarray(res["k"], np.int64), res["maxsil"]


def sharp_large(X: np.ndarray, R: torch.Tensor, perm: np.ndarray, cfg: dict, dev,
                prefer: Optional[dict] = None) -> LargeRef:
    """The large tier on cells X (n, genes, host), RP matrices R (genes,
    K * p) and the cell permutation `perm` -> LargeRef. `prefer`, the
    program's answer: `k_per` (T, K) and `labels` (n,) final labels."""
    n = X.shape[0]
    perm = np.asarray(perm, np.int64)
    sizes = fold_sizes(n, cfg["partition_ncells"])
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    R = R.to(dev, torch.float32)
    folds = np.empty(n, np.int32)
    viE = np.empty((n, cfg["p"]), np.float32)
    summaries, k_per, maxsil = [], [], []
    for t, sz in enumerate(sizes):
        rows = perm[offsets[t] : offsets[t] + sz]
        want = None
        if prefer is not None:
            want = {"k_per": prefer["k_per"][t], "finalC": prefer["labels"][rows]}
        summary, mean_proj, k, ms = fold(torch.as_tensor(X[rows], device=dev), R, cfg, want)
        summaries.append(summary)
        folds[rows] = t
        viE[rows] = mean_proj
        k_per.append(k)
        maxsil.append(ms)
    block = meta.fuse_block(summaries, cfg, dev, prefer=None if prefer is None else prefer["labels"][perm])
    raw = np.empty(n, np.int64)
    raw[perm] = block.labels
    return LargeRef(labels=meta.finalize(raw, merge_tiny=n > 1e4), folds=folds, viE=viE,
                    k_per=np.stack(k_per), maxsil=np.stack(maxsil))
