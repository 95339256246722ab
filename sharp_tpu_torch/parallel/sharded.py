"""The grouped fold loop of the large tier, on one device.

Counterpart of the single-device part of `sharp_tpu/parallel/sharded.py`
(`auto_group`, `process_folds_grouped`, dense input). Folds are processed
`group` at a time through `core/fold.fold_program`: one group's G*K
ensemble members share one projection, one ladder (its rounds and its
tail kernel are paid once per group, not once per fold) and one cut-replay
launch. Every lane of a group is computed as if alone, so the results do
not depend on the group size. The mesh variants (folds and ensemble members
over several cards) and the SparseBlock feed are not ported yet
(ROADMAP.md, Queue 1 items 8-9).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from sharp_tpu.config import SharpConfig
from sharp_tpu_torch.core.fold import fold_program, fold_static_args
from sharp_tpu_torch.core.large import summaries_to_host
from sharp_tpu_torch.utils.timers import log

_CPU_BUDGET = 8 << 30


def memory_budget_bytes(device) -> int:
    """Memory for one group's working set: 80% of the card's free memory
    (`torch.cuda.mem_get_info`) for a CUDA device, 8 GiB otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        return int(0.8 * free)
    return _CPU_BUDGET


def auto_group(block_pad: int, genes: int, K: int, device, cap: int = 16) -> int:
    """Fold-group size that fits the memory budget, at most `cap`.

    Per fold, a group holds the dense block and its log2 copy on the device
    plus the host-staged copy (3 x block_pad x genes float32), and K lanes
    of the linkage working set: the distance matrix, its masked copy for
    the silhouettes and up to three matrices inside a ladder round
    (5 x K x block_pad^2 float32).
    """
    fold_bytes = 3 * block_pad * genes * 4 + 5 * K * block_pad * block_pad * 4
    fit = memory_budget_bytes(device) // fold_bytes
    for g in (16, 8, 4, 2):
        if fit >= g and cap >= g:
            return g
    return 1


def process_folds_grouped(
    X: np.ndarray,               # (n, genes) cells
    sizes: Sequence[int],        # fold sizes
    block_pad: int,
    R_all: torch.Tensor,         # (genes, K*p) on the device
    cfg: SharpConfig,
    logf: bool,
    device,
    group: Optional[int] = None,
    rows: Optional[np.ndarray] = None,
) -> List[dict]:
    """Run the fold program over all folds, `group` folds per call, and
    return per-fold host summaries.

    Fold t holds the cells rows[offsets[t] : offsets[t] + sizes[t]] of X
    (`rows`: the cell order, default X's own). `group=None` sizes the group
    from the memory budget (`auto_group`).
    """
    dev = torch.device(device)
    T = len(sizes)
    genes = X.shape[1]
    static = fold_static_args(cfg)
    if group is None:
        group = auto_group(block_pad, genes, cfg.ensize_K, dev)
        log(f"fold group auto-sized to {group}")
    group = max(1, min(group, T))
    rows = np.arange(X.shape[0]) if rows is None else np.asarray(rows)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    results: List[dict] = []
    for g0 in range(0, T, group):
        gsizes = [int(s) for s in sizes[g0 : g0 + group]]
        Xg = np.zeros((len(gsizes), block_pad, genes), np.float32)
        for gi, sz in enumerate(gsizes):
            r0 = offsets[g0 + gi]
            np.take(X, rows[r0 : r0 + sz], axis=0, out=Xg[gi, :sz], mode="clip")
        masks = torch.arange(block_pad)[None, :] < torch.tensor(gsizes)[:, None]
        out = fold_program(
            torch.from_numpy(Xg).to(dev), masks.to(dev), gsizes, R_all, logf,
            cfg.indN_cluster, **static,
        )
        results.extend(summaries_to_host(out, gsizes, cfg.forview))
    return results
