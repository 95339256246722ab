"""Plain reference of SHARP's small tier from the raw matrix: the prep
(clamp, all-zero-gene drop), CPM, the testlog decision, the K members'
projection, Ward and cut choice, wMetaC and the final relabelling.

Written from SHARP's R/SHARP.R:82-117 (preprocessing), :202-228 and
:877-924 (the log decision) and :339-454 (SHARP_small), composing the
pieces of `cluster.py`, `meta.py` and `large.py`; imports torch and numpy
only, and nothing of the program under test. Float32, TF32 off where the
caller holds `cluster.full_float32()`. Departures from R/SHARP.R:

  * the removal of duplicate gene and cell names (:82-97) is skipped:
    the callers pass no names;
  * the K RP matrices (:541-549) and the testlog's draws (the cell
    permutation whose first `sncells` cells are probed and the probe's RP
    matrix, :877-924) are inputs, the draws the program was handed;
  * CPM divides each cell by its sum floored at 1e-12, then scales by
    1e6, in float32 (R's doubles);
  * the members run `meta.fold`'s steps spelt out (projection,
    distances, Ward and cut choice, wMetaC), to keep each member's chosen
    k, which `meta.fold` does not return; the knobs are `large.config`'s
    at the data set's size, which at n < 5,000 are the small tier's
    (maxN 40, candidates 2..40);
  * the end is `meta.finalize`, whose tiny-cluster merge runs only above
    1e4 cells (:418-443), so never here;
  * `prefer`, the program's answer, picks among the choices the
    reference's rounding cannot tell apart (`meta._closest`,
    `cluster.choose`): each member's k from the program's per-member k,
    the consensus from the program's final labels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from perfbench.reference import meta
from perfbench.reference.cluster import opt_hclust, pearson_distance, project
from perfbench.reference.large import config
from perfbench.reference.meta import nc_pad


class SmallRef(NamedTuple):
    labels: np.ndarray     # (n,) final labels 1..C
    viE: np.ndarray        # (n, p) ensemble-mean projection
    k_per: np.ndarray      # (K,) each member's chosen cluster count
    maxsil: np.ndarray     # (K,) each member's max median silhouette
    log: bool              # the testlog decision
    genes: int             # genes after the prep


def preprocess(X: torch.Tensor, exp_type: Optional[str], prep: bool = True) -> torch.Tensor:
    """Raw cells x genes -> the matrix the small tier clusters: negatives
    clamped and genes zero in every cell dropped (`prep`), then CPM where
    `exp_type` is given and is neither CPM nor TPM (R/SHARP.R:99-117)."""
    X = X.float()
    if prep:
        X = torch.clamp_min(X, 0.0)
        X = X[:, X.sum(dim=0) > 0]
    if exp_type is not None and exp_type.upper() not in ("CPM", "TPM"):
        X = X / torch.clamp_min(X.sum(dim=1, keepdim=True), 1e-12) * 1e6
    return X


def testlog(X: torch.Tensor, perm: torch.Tensor, R_probe: torch.Tensor, kind: str, sncells: int = 100) -> bool:
    """The log decision (R/SHARP.R:877-924): the first `sncells` cells of
    `perm` projected by the probe's RP matrix raw and log2-transformed and
    clustered (candidates 2..40, no silhouette threshold); log2 iff the
    raw max silhouette is below 0.75 and at least 0.95 of the logged
    one."""
    sub = X[perm[: min(sncells, X.shape[0])].to(X.device)]
    R = R_probe.to(X.device).float()
    Z = torch.stack([project(sub, R, 1, False, kind)[0], project(sub, R, 1, True, kind)[0]])
    ms = opt_hclust(pearson_distance(Z, kind), Z, minN=2, ncand=39, maxN=40, nc_cap=nc_pad(40) - 1,
                    sil_thre=0.0, height_Ntimes=2.0)["maxsil"]
    return bool(ms[0] < 0.75 and ms[0] >= 0.95 * ms[1])


def sharp_small(X: torch.Tensor, R: torch.Tensor, perm: torch.Tensor, R_probe: torch.Tensor, K: int, p: int,
                exp_type: Optional[str], *, kind: str = "float32", prefer: Optional[dict] = None) -> SmallRef:
    """The small tier on raw cells X (n, genes) on the device that holds
    it, the stacked RP matrices R (genes kept, K * p), the testlog's
    permutation and probe RP matrix, in the precision `kind` -> SmallRef.
    `prefer`, the program's answer: `k_per` (K,) and `labels` (n,)."""
    X = preprocess(X, exp_type)
    n = X.shape[0]
    cfg = config(n, K, p=p, rp_kind=kind)
    log = testlog(X, perm, R_probe, kind)
    prefer = prefer or {}
    proj = project(X, R.to(X.device).float(), K, log, kind)                # (K, n, p)
    res = opt_hclust(pearson_distance(proj, kind), proj, minN=cfg["minN"], ncand=cfg["ncand"],
                     maxN=cfg["maxN"], nc_cap=cfg["nc_cap"], sil_thre=cfg["sil_thre"],
                     height_Ntimes=cfg["height_Ntimes"], prefer_k=prefer.get("k_per"))
    finalC = meta.wmetac(res["labels"].T, maxN=cfg["maxN"], minN=cfg["minN"], ncand=cfg["ncand"],
                         nc_cap=cfg["nc_cap"], sim_width=cfg["sim_width"], height_Ntimes=cfg["height_Ntimes"],
                         prefer=prefer.get("labels"))
    return SmallRef(labels=meta.finalize(finalC, merge_tiny=n > 1e4), viE=proj.mean(dim=0).cpu().numpy(),
                    k_per=np.asarray(res["k"], np.int64), maxsil=res["maxsil"], log=log, genes=X.shape[1])
