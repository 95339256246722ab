"""Plain reference of SHARP_unlimited over a list of CSR blocks:
each block's folds, their ensembles and wMetaC, the block's own sMetaC
fuse, the global sMetaC over the blocks' clusters and the relabel by
decreasing size.

Written from R/SHARP_unlimited.R:29-242 and R/SHARP_unlimited3.R:59-131,
composing the pieces of `large.py`, `meta.py` and `cluster.py`; imports
torch and numpy only, and nothing of the program under test. Float32, TF32
off where the caller holds `cluster.full_float32()`. Block by block, in
order: each fold is densified from the CSR with plain indexing (duplicate
entries summed), log2(1 + x) applied, and run through `large.fold` (its
members, wMetaC and its summary); the block's folds are fused by
`meta.fuse_block`. Departures from the R code:

  * R's per-block SHARP() call reshuffles the cells of a block below 1e5
    cells (R/SHARP.R:493-507); the ports take each block's cells in their
    own order, its folds contiguous (`data/atlas.fold_sizes`), and so does
    the reference;
  * the view RP (R/SHARP_unlimited.R:216-235) is off: no viE;
  * the knobs are those of the whole data set (`large.config` at the
    total cell count), where R's per-block SHARP() resolves maxN.cluster
    and sMetaC's range at the block's: the ports resolve one configuration
    for the run, and each block fuse takes sMetaC's range at the total
    count, as `meta.fuse_block` reads `cfg["n_cells"]`;
  * the global fuse relabels by decreasing size with no tiny-cluster
    merge, as R/SHARP_unlimited3.R and the ports do (the
    in-memory R/SHARP_unlimited.R merges clusters under 10 cells first,
    :168-177);
  * the K RP matrices `R` are an input, the draw the program was handed
    (R/SHARP_unlimited.R:96-105 draws them once for every block);
  * `prefer`, the program's answer, picks among the choices the
    reference's rounding cannot tell apart (`meta._closest`,
    `cluster.choose`), as in `large.py`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from perfbench.data.atlas import fold_sizes
from perfbench.reference import large, meta
from perfbench.reference.meta import BlockFuse, pad_dim

config = large.config


class UnlimitedRef(NamedTuple):
    labels: np.ndarray        # (n,) final labels 1..C, by decreasing size, blocks in order
    folds: np.ndarray         # (n,) each cell's fold, numbered across the blocks
    k_per: np.ndarray         # (T, K) each member's chosen cluster count
    maxsil: np.ndarray        # (T, K) each member's max median silhouette
    fold_labels: np.ndarray   # (n,) each cell's fold consensus
    block_labels: np.ndarray  # (n,) each cell's cluster of its block's fuse
    cent_sum: np.ndarray      # (T, nc_pad, p) each fold's centroid sums
    counts: np.ndarray        # (T, nc_pad) each fold's cells by label


def csr_parts(X):
    """(indptr, indices, data, (rows, genes)) of a scipy CSR matrix."""
    return np.asarray(X.indptr), np.asarray(X.indices), np.asarray(X.data), X.shape


def densify(X, r0: int, r1: int, dev) -> torch.Tensor:
    """Rows r0..r1 of a CSR matrix as a dense float32 (r1 - r0, genes)
    tensor on dev."""
    indptr, indices, data, (_, genes) = csr_parts(X)
    p0, p1 = int(indptr[r0]), int(indptr[r1])
    per_row = torch.as_tensor(np.diff(indptr[r0 : r1 + 1]).astype(np.int64), device=dev)
    rows = torch.repeat_interleave(torch.arange(r1 - r0, device=dev), per_row)
    cols = torch.as_tensor(indices[p0:p1], device=dev).long()
    out = torch.zeros((r1 - r0, genes), dtype=torch.float32, device=dev)
    out.index_put_((rows, cols), torch.as_tensor(data[p0:p1], device=dev).float(), accumulate=True)
    return out


def global_fuse(blocks: List[BlockFuse], cfg: dict, dev, prefer=None) -> np.ndarray:
    """The global sMetaC over the blocks' clusters and the final label
    (1-based, by decreasing size) of every cell, blocks in order
    (R/SHARP_unlimited3.R:155-227); `prefer`: the program's final labels."""
    cents = np.concatenate([b.cents for b in blocks])
    counts = np.concatenate([b.counts for b in blocks])
    NC = len(counts)
    minN, maxN = meta.smetac_range(cfg["n_cells"], cfg["minN"], cfg["maxN_cluster"], NC)
    maxN = min(maxN, NC - 1) if NC > 1 else 1
    if maxN < minN:
        minN = max(2, maxN)
    tfs, rooms = meta.smetac(cents, minN=minN, ncand=max(maxN - minN + 1, 1), maxN=maxN,
                             meta_cap=((min(maxN, NC) + 9) // 8) * 8 - 1, width=pad_dim(NC),
                             sil_thre=cfg["sil_thre"], height_Ntimes=cfg["height_Ntimes"], dev=dev)
    offsets = np.concatenate([[0], np.cumsum([len(b.counts) for b in blocks])])
    options = []
    for tf in tfs:
        sizes = np.zeros(int(tf.max()) + 1)
        np.add.at(sizes, tf, counts)
        remap = np.empty(len(sizes), np.int64)
        remap[np.argsort(-sizes, kind="stable")] = np.arange(1, len(sizes) + 1)
        options.append(np.concatenate([remap[tf[offsets[i] + b.labels]] for i, b in enumerate(blocks)]))
    return options[meta._closest(options, prefer, rooms)]


def sharp_unlimited(blocks: Sequence, R: torch.Tensor, cfg: dict, dev, prefer: Optional[dict] = None) -> UnlimitedRef:
    """SHARP_unlimited on CSR blocks (scipy matrices, cells by genes,
    host), RP matrices R (genes, K * p) and `config(...)`'s knobs ->
    UnlimitedRef. `prefer`, the program's answer: `k_per` (T, K),
    `fold_labels`, `block_labels` and `labels` (n,)."""
    R = R.to(dev, torch.float32)
    fold = cfg["partition_ncells"]
    fused, folds, k_per, maxsil, fold_labels, sums, counts = [], [], [], [], [], [], []
    row0 = t = 0
    for X in blocks:
        n = X.shape[0]
        summaries, r0 = [], 0
        for sz in fold_sizes(n, fold):
            cells = slice(row0 + r0, row0 + r0 + sz)
            want = None
            if prefer is not None:
                want = {"k_per": prefer["k_per"][t], "finalC": prefer["fold_labels"][cells]}
            summary, _, k, ms = large.fold(densify(X, r0, r0 + sz, dev), R, cfg, want)
            summaries.append(summary)
            folds.append(np.full(sz, t, np.int32))
            k_per.append(k)
            maxsil.append(ms)
            fold_labels.append(np.asarray(summary["finalC"]))
            sums.append(summary["cent_sum"])
            counts.append(summary["counts"])
            r0 += sz
            t += 1
        block_prefer = None if prefer is None else prefer["block_labels"][row0 : row0 + n]
        fused.append(meta.fuse_block(summaries, cfg, dev, prefer=block_prefer))
        row0 += n
    labels = global_fuse(fused, cfg, dev, prefer=None if prefer is None else prefer["labels"])
    return UnlimitedRef(labels=labels, folds=np.concatenate(folds), k_per=np.stack(k_per), maxsil=np.stack(maxsil),
                        fold_labels=np.concatenate(fold_labels), block_labels=np.concatenate([b.labels for b in fused]),
                        cent_sum=np.stack(sums), counts=np.stack(counts))
