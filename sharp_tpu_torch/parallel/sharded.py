"""The grouped fold loop of the large tier, on one device.

Counterpart of the single-device part of `sharp_tpu/parallel/sharded.py`
(`auto_group`, `process_folds_grouped`). Folds are processed `group` at a
time through `core/fold.fold_program`: one group's G*K ensemble members
share one projection, one ladder (its rounds and its tail kernel are paid
once per group, not once per fold) and one cut-replay launch. Every lane of
a group is computed as if alone, so the results do not depend on the group
size.

A dense block is gathered into each group on the host and copied over. A
`SparseBlock` ships each group as CSR triplets and is densified on the
device (`io/sparse.py`), with log2(1 + x) applied to the values there; a
worker thread slices the next group into page-locked staging buffers while
the device runs the current one. The mesh variants (folds and ensemble
members over several cards) are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import concurrent.futures
from typing import List, Optional, Sequence

import numpy as np
import torch

from sharp_tpu_torch.config import SharpConfig
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


def auto_group(
    block_pad: int, genes: int, K: int, device, sparse: bool = False, cap: int = 16
) -> int:
    """Fold-group size that fits the memory budget, at most `cap`.

    Per fold, a group holds K lanes of the linkage working set (the
    distance matrix, its masked copy for the silhouettes and up to three
    matrices inside a ladder round: 5 x K x block_pad^2 float32) and the
    dense fold: with the dense feed, the fold and its log2 copy on the
    device plus the host-staged copy (3 x block_pad x genes float32); with
    the sparse feed, the fold densified on the device with log2 applied
    and the scatter's working set (2 x block_pad x genes float32).
    """
    dense_copies = 2 if sparse else 3
    fold_bytes = dense_copies * block_pad * genes * 4 + 5 * K * block_pad * block_pad * 4
    fit = memory_budget_bytes(device) // fold_bytes
    for g in (16, 8, 4, 2):
        if fit >= g and cap >= g:
            return g
    return 1


def _dense_feed(X, sizes, offsets, group, block_pad, rows, logf, dev):
    """Per group: (fold sizes, dense folds on dev, log2 still to apply)."""
    genes = X.shape[1]
    for g0 in range(0, len(sizes), group):
        gsizes = [int(s) for s in sizes[g0 : g0 + group]]
        Xg = np.zeros((len(gsizes), block_pad, genes), np.float32)
        for gi, sz in enumerate(gsizes):
            r0 = offsets[g0 + gi]
            np.take(X, rows[r0 : r0 + sz], axis=0, out=Xg[gi, :sz], mode="clip")
        yield gsizes, torch.from_numpy(Xg).to(dev), logf


def _sparse_feed(sb, sizes, offsets, group, block_pad, logf, dev, wire_dtype):
    """Per group: (fold sizes, folds densified on dev with log2 applied,
    False). Group g is sliced into staging set g % 2 on a worker thread
    while the caller runs group g - 1; on a card the sets are page-locked
    and copied without blocking, and a set is refilled only after the copy
    out of it has finished."""
    from sharp_tpu_torch.io.sparse import densify_folds, fold_triplets, nnz_pad, wire_buffers

    T = len(sizes)
    budget = nnz_pad(max(int(sb.indptr[offsets[t] + sizes[t]] - sb.indptr[offsets[t]]) for t in range(T)))
    cuda = dev.type == "cuda"
    sets = [wire_buffers(group, block_pad, budget, sb.g, wire_dtype, pin=cuda) for _ in range(2)]
    copied = [None, None]   # CUDA event after the copy out of each set

    def stage(gi):
        g0 = gi * group
        gsizes = [int(s) for s in sizes[g0 : g0 + group]]
        if copied[gi % 2] is not None:
            copied[gi % 2].synchronize()
        starts = [int(offsets[g0 + j]) for j in range(len(gsizes))]
        return gsizes, fold_triplets(sb, starts, gsizes, block_pad, budget, wire_dtype, out=sets[gi % 2])

    n_groups = (T + group - 1) // group
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        staged = pool.submit(stage, 0)
        for gi in range(n_groups):
            gsizes, host = staged.result()
            data = [t.to(dev, non_blocking=True) for t in host]
            if cuda:
                copied[gi % 2] = torch.cuda.Event()
                copied[gi % 2].record()
            if gi + 1 < n_groups:
                staged = pool.submit(stage, gi + 1)
            Xg = densify_folds(*data, block_pad=block_pad, genes=sb.g, log2p1=logf)
            del data
            yield gsizes, Xg, False


def process_folds_grouped(
    X,                           # (n, genes) cells, or a SparseBlock
    sizes: Sequence[int],        # fold sizes
    block_pad: int,
    R_all: torch.Tensor,         # (genes, K*p) on the device
    cfg: SharpConfig,
    logf: bool,
    device,
    group: Optional[int] = None,
    rows: Optional[np.ndarray] = None,
    wire_dtype: str = "float32",
) -> List[dict]:
    """Run the fold program over all folds, `group` folds per call, and
    return per-fold host summaries.

    Fold t holds the cells rows[offsets[t] : offsets[t] + sizes[t]] of X
    (`rows`: the cell order, default X's own; a SparseBlock keeps its own
    order). `group=None` sizes the group from the memory budget
    (`auto_group`). `wire_dtype` is the sparse feed's value type.
    """
    from sharp_tpu_torch.io.sparse import SparseBlock

    dev = torch.device(device)
    T = len(sizes)
    genes = X.shape[1]
    sparse = isinstance(X, SparseBlock)
    static = fold_static_args(cfg)
    if group is None:
        group = auto_group(block_pad, genes, cfg.ensize_K, dev, sparse=sparse)
        log(f"fold group auto-sized to {group}")
    group = max(1, min(group, T))
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    if sparse:
        if rows is not None:
            raise ValueError("a SparseBlock is processed in its own cell order (rows=None)")
        feed = _sparse_feed(X, sizes, offsets, group, block_pad, logf, dev, wire_dtype)
    else:
        rows = np.arange(X.shape[0]) if rows is None else np.asarray(rows)
        feed = _dense_feed(X, sizes, offsets, group, block_pad, rows, logf, dev)

    results: List[dict] = []
    for gsizes, Xg, eff_logf in feed:
        masks = torch.arange(block_pad)[None, :] < torch.tensor(gsizes)[:, None]
        out = fold_program(
            Xg, masks.to(dev), gsizes, R_all, eff_logf, cfg.indN_cluster, **static,
        )
        del Xg
        results.extend(summaries_to_host(out, gsizes, cfg.forview))
    return results
