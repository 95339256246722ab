"""Public API: `sharp`, `run_mtimes`, `summarize_mtimes`, `sharp_unlimited`.

Counterpart of `sharp_tpu/api.py`, with the same knobs, plus a `device`
keyword. The device is never picked on its own: it defaults to "cuda" and
a CUDA request without a card raises. `device="cpu"` runs the plain
versions of the kernels.

`sharp` runs both tiers: the small tier (n < base_ncells) on one padded
block, the large tier as folds of about partition_ncells cells, wMetaC per
fold and sMetaC across folds. Ward linkage goes through the serial Ward
kernel up to a padded size of 1024 and through the reciprocal-NN ladder
with its tail kernel above ("auto"); `linkage_backend="pallas_bf16"` takes
the serial kernel with bf16 storage at every size. `n_devices > 1` runs the
large tier's folds (and, with `ensemble_axis`, its ensemble members) over a
mesh of devices (`parallel/mesh.py`, `parallel/sharded.py`), with the
labels of one device.

`sharp_unlimited` (from `parallel/streaming.py`) streams blocks (in memory
or SBLK files) through the fold pass of the large tier, one sMetaC fuse
per block and one global sMetaC over the block clusters; with
`multihost=True` over several processes (`parallel/multihost.py`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from sharp_tpu_torch.config import pad_dim, resolve_config
from sharp_tpu_torch.types import SharpResult
from sharp_tpu_torch.core.large import sharp_large
from sharp_tpu_torch.core.pipeline import TestlogProbe, preprocess, sharp_small
from sharp_tpu_torch.ops.linkage import resolve_linkage_backend
from sharp_tpu_torch.parallel.streaming import sharp_unlimited  # re-exported
from sharp_tpu_torch.utils.prng import resolve_seed
from sharp_tpu_torch.utils.timers import StageTimer, span


def resolve_device(device) -> torch.device:
    """The requested device, checked: a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def stack_rm(rM, want, note: str = "") -> torch.Tensor:
    """The reference's `rM` (R/SHARP.R:541-549; a list of K (genes, p)
    matrices or one stacked (genes, K * p) array, numpy or torch) as one
    stacked tensor, which must have the shape `want`; `note` ends the
    error's explanation."""
    def as_tensor(m):
        return m if isinstance(m, torch.Tensor) else torch.from_numpy(np.array(m))

    R_all = torch.cat([as_tensor(m) for m in rM], dim=1) if isinstance(rM, (list, tuple)) else as_tensor(rM)
    if tuple(R_all.shape) != tuple(want):
        raise ValueError(
            f"rM has shape {tuple(R_all.shape)}, expected {tuple(want)} "
            f"(genes x ensize_K * reduced_ndim{', ' + note if note else ''})"
        )
    return R_all


def sharp(
    X: np.ndarray,
    *,
    gene_names: Optional[np.ndarray] = None,
    cell_names: Optional[np.ndarray] = None,
    cells_axis: int = 0,
    rM: Optional[object] = None,
    testlog_probe: Optional[TestlogProbe] = None,
    shuffle_perm: Optional[torch.Tensor] = None,
    device="cuda",
    **knobs,
) -> SharpResult:
    """Cluster a cells-by-genes expression matrix (~ SHARP(), R/SHARP.R:44).

    Accepts the reference knobs as keyword args (`ensize_K`, `reduced_ndim`,
    `base_ncells`, `partition_ncells`, `N_cluster`, `minN_cluster`,
    `maxN_cluster`, `sil_thre`, `height_Ntimes`, `prep`, `logflag`,
    `exp_type`, `rN_seed`, `forview`, `linkage_backend`, ...) with the JAX
    package's auto-defaults (`sharp_tpu_torch.config`), and dispatches the small
    or the large tier on `base_ncells` as the reference does
    (R/SHARP.R:251-280).

    cells_axis=1 accepts the reference's genes-by-cells orientation.

    `rM` injects pre-generated RP matrices (the reference's rM argument,
    R/SHARP.R:541-549): a list of K (genes, p) matrices or one stacked
    (genes, K * p) array, numpy or torch. `testlog_probe` injects the
    testlog draws (`sharp_tpu_torch.carry.testlog_probe_from_jax`) and
    `shuffle_perm` the large tier's cell reshuffle
    (`carry.shuffle_perm_from_jax`; the small tier does not reshuffle).
    Callers injecting rM usually also pass prep=False so the gene dimension
    is not altered under the matrices.
    """
    with span("api"):
        dev = resolve_device(device)
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError("X must be 2-D (cells x genes)")
        if cells_axis == 1:
            X = X.T

        n, g = X.shape
        cfg = resolve_config(n, g, **knobs)
        timer = StageTimer("small" if cfg.is_small else "large")
        n_pad = pad_dim(n) if cfg.is_small else cfg.block_pad
        resolve_linkage_backend(cfg.linkage_backend, n_pad, cfg.hmethod)
        rN_seed = resolve_seed(cfg.rN_seed)

        with timer.stage("preprocess"):
            X = preprocess(X, cfg, gene_names=gene_names, cell_names=cell_names)
            cfg = cfg.replace(n_genes=X.shape[1])

        R_all = None
        if rM is not None:
            R_all = stack_rm(rM, (X.shape[1], cfg.ensize_K * cfg.reduced_ndim),
                             "after preprocessing — pass prep=False to keep the gene dimension fixed")

        if cfg.is_small:
            return sharp_small(
                X, cfg, rN_seed, dev, timer, R_all=R_all, testlog_probe=testlog_probe
            )
        return sharp_large(
            X, cfg, rN_seed, dev, timer, R_all=R_all, testlog_probe=testlog_probe,
            shuffle_perm=shuffle_perm,
        )


def run_mtimes(
    X: np.ndarray,
    mtimes: int = 5,
    k_set: Sequence[int] = (15,),
    **knobs,
) -> List[List[SharpResult]]:
    """Grid-run sharp `mtimes` x len(k_set) times for variance studies
    (~ run_Mtimes_SHARP, R/run_Mtimes_SHARP.R:20-60)."""
    seed = knobs.pop("rN_seed", None)
    out = []
    for K in k_set:
        row = []
        for m in range(mtimes):
            row.append(
                sharp(X, ensize_K=K, rN_seed=(None if seed is None else seed + m), **knobs)
            )
        out.append(row)
    return out


def summarize_mtimes(grid, truth=None) -> dict:
    """Stability summary of a `run_mtimes` grid: per-K cluster-count
    distribution, mean pairwise ARI between runs, and accuracy vs `truth`
    when given (R/run_Mtimes_SHARP.R:20-60)."""
    from sharp_tpu_torch.analysis.ari import ari

    summary = {}
    for row in grid:
        K = row[0].paras["ensize_K"]
        pair = [
            ari(row[a].pred_clusters, row[b].pred_clusters)
            for a in range(len(row))
            for b in range(a + 1, len(row))
        ]
        entry = {
            "n_clusters": [r.N_pred_cluster for r in row],
            "pairwise_ari_mean": float(np.mean(pair)) if pair else 1.0,
        }
        if truth is not None:
            vals = [ari(truth, r.pred_clusters) for r in row]
            entry["truth_ari_mean"] = float(np.mean(vals))
            entry["truth_ari_std"] = float(np.std(vals))
        summary[int(K)] = entry
    return summary
