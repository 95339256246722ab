"""TPM-like expression with planted types, made on the host from the seed.

The recipe of the repository's synthetic acceptance data (a log-normal
gene base, one shared set of 35% differentially expressed genes with
per-type signs at +/-6 log2 fold change, log-normal noise of sigma 0.3, 20%
dropout, each cell scaled to 1e6), with types of equal size so that every
seed makes the same amount of work.
"""

from __future__ import annotations

import numpy as np


def make(n_cells: int, n_genes: int, n_types: int, seed: int):
    """-> (X (n_cells, n_genes) float32, planted types (n_cells,))."""
    rng = np.random.default_rng(int(seed))
    base = rng.lognormal(mean=1.0, sigma=1.0, size=n_genes)
    y = rng.permutation(np.arange(n_cells) % n_types)
    de = rng.choice(n_genes, int(0.35 * n_genes), replace=False)
    means = np.tile(base, (n_types, 1))
    means[:, de] *= 2.0 ** (rng.choice([-1.0, 1.0], (n_types, len(de))) * 6.0)
    X = means[y] * rng.lognormal(mean=0.0, sigma=0.3, size=(n_cells, n_genes))
    X *= rng.random((n_cells, n_genes)) > 0.2
    X /= np.maximum(X.sum(axis=1, keepdims=True), 1e-9) / 1e6
    return X.astype(np.float32), y
