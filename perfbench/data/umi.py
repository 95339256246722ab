"""10x-like UMI counts with planted types of skewed sizes, made on the
card from the seed.

One droplet sample as Cell Ranger's filtered matrix holds it: each gene a
base weight, log-normal with a heavy tail (a few genes take most of a
cell's UMIs), and a share of the genes never detected in the sample
(weight 0); each planted type raises its own marker genes by a log2 fold
change; each cell has a library size (log-normal UMIs) and its counts are
drawn Poisson from its library size times its type's gene shares. The
types have fixed sizes (`type_sizes` of the configuration's shares), so
every seed makes the same amount of work, and the cells' order is a
permutation from the seed.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

# rows drawn at a time, to bound the rates' memory on the device
CHUNK = 512


class Sample(NamedTuple):
    X: np.ndarray          # (cells, genes) float32 UMI counts, host memory
    truth: np.ndarray      # (cells,) planted type of each cell
    detected: np.ndarray   # (genes,) bool: the gene has a count in some cell


def type_sizes(n_cells: int, shares: Sequence[float]) -> list:
    """Cells of each type: the shares rounded down, the remainder to the
    largest types first."""
    shares = np.asarray(shares, np.float64) / np.sum(shares)
    sizes = np.floor(shares * n_cells).astype(np.int64)
    for t in np.argsort(-shares, kind="stable")[: n_cells - int(sizes.sum())]:
        sizes[t] += 1
    return [int(s) for s in sizes]


def make(n_cells: int, n_genes: int, shares: Sequence[float], seed: int, dev, *, median_umis: float,
         umi_sigma: float, gene_sigma: float, never_detected: float, marker_pool: int, markers: int,
         marker_lfc: Sequence[float]) -> Sample:
    """The sample drawn on `dev` from `seed` and copied once into host
    memory. Each type's `markers` marker genes are drawn from the
    `marker_pool` genes of largest weight (markers are well expressed, as
    a PBMC type's are), each raised by a log2 fold change drawn uniformly
    from `marker_lfc` (low, high)."""
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    T = len(shares)
    w = torch.exp(gene_sigma * torch.randn(n_genes, generator=g, device=dev))
    w = torch.where(torch.rand(n_genes, generator=g, device=dev) < never_detected, 0.0, w)
    pool = torch.argsort(w, descending=True)[:marker_pool]
    picks = torch.argsort(torch.rand((T, len(pool)), generator=g, device=dev), dim=1)[:, :markers]
    marker = torch.zeros((T, n_genes), dtype=torch.bool, device=dev)
    marker[torch.arange(T, device=dev)[:, None], pool[picks]] = True
    lo, hi = marker_lfc
    lfc = lo + (hi - lo) * torch.rand((T, n_genes), generator=g, device=dev)
    prof = w[None, :] * torch.where(marker, torch.exp2(lfc), 1.0)
    prof = prof / prof.sum(dim=1, keepdim=True)
    sizes = torch.as_tensor(type_sizes(n_cells, shares), device=dev)
    y = torch.repeat_interleave(torch.arange(T, device=dev), sizes)
    y = y[torch.randperm(n_cells, generator=g, device=dev)]
    lib = median_umis * torch.exp(umi_sigma * torch.randn(n_cells, generator=g, device=dev))
    X = np.empty((n_cells, n_genes), np.float32)
    host = torch.from_numpy(X)
    detected = torch.zeros(n_genes, dtype=torch.bool, device=dev)
    for r0 in range(0, n_cells, CHUNK):
        rows = slice(r0, min(r0 + CHUNK, n_cells))
        counts = torch.poisson(lib[rows, None] * prof[y[rows]], generator=g)
        detected |= (counts > 0).any(dim=0)
        host[rows].copy_(counts)
    return Sample(X, y.cpu().numpy(), detected.cpu().numpy())
