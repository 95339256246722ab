"""The atlas's inputs, made on the card from the run's seed: the fold plan,
the expression of each fold group and the ensemble's RP matrices.

The expression follows the flagship bench's recipe (a log-normal base,
35% of the genes differentially expressed at +/-6 log2 fold change per
planted type, exp(0.3 N) noise, 20% dropout, each cell scaled to 1e6),
drawn with `torch.Generator`s on the device: one for the type means and
one per fold, so any fold can be made again on its own for the check.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch


def seeds(seed: int, n: int) -> List[int]:
    """n independent 63-bit seeds derived from the run's seed."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, dtype=np.uint64)
    return [int(s) & ((1 << 63) - 1) for s in state]


def block_sizes(n_cells: int, block_cells: int) -> List[int]:
    """Blocks of `block_cells`, the remainder joined to the last
    (1,306,127 -> 25 x 50,000 + 56,127)."""
    out, left = [], n_cells
    while left > 0:
        take = block_cells if left >= 2 * block_cells else left
        out.append(take)
        left -= take
    return out


def fold_sizes(n: int, fold: int) -> List[int]:
    """Folds of `fold` cells, the last two rebalanced (R/SHARP.R:513-536)."""
    if n <= fold:
        return [n]
    T = -(-n // fold)
    rem = n - fold * (T - 1)
    if rem < fold:
        tot = fold + rem
        return [fold] * (T - 2) + [tot - tot // 2, tot // 2]
    return [fold] * (T - 1) + [rem]


def fold_plan(blocks: List[int], fold: int) -> List[Tuple[int, int]]:
    """(block, fold size) of every fold, in global fold order."""
    return [(b, sz) for b, bn in enumerate(blocks) for sz in fold_sizes(bn, fold)]


def pad_rows(n: int) -> int:
    """The fold program's padded rows for a fold of n cells."""
    n = max(n, 8)
    return 1 << (n - 1).bit_length() if n <= 512 else -(-n // 512) * 512


def ternary_rp(m: int, cols: int, seed: int, dev, dtype=torch.float32) -> torch.Tensor:
    """(m, cols) very sparse ternary RP matrix: +/-sqrt(s) w.p. 1/(2s) each,
    0 otherwise, s = sqrt(m) (R/ranM.R:17-30), in one draw on `dev`."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    s = math.sqrt(m)
    u = torch.rand((m, cols), generator=g, device=dev)
    r = torch.where(u < 0.5 / s, math.sqrt(s), torch.where(u > 1.0 - 0.5 / s, -math.sqrt(s), 0.0))
    return r.to(dtype)


class AtlasData:
    """The atlas's expression, fold by fold, on `dev`."""

    def __init__(self, n_genes: int, n_types: int, B: int, seed: int, dev):
        self.n_genes, self.n_types, self.B, self.dev = n_genes, n_types, B, dev
        means_seed, self.fold_seed = seeds(seed, 2)
        g = torch.Generator(device=dev)
        g.manual_seed(means_seed)
        base = torch.exp(1.0 + torch.randn(n_genes, generator=g, device=dev))
        de = torch.rand(n_genes, generator=g, device=dev) < 0.35
        signs = torch.randint(0, 2, (n_types, n_genes), generator=g, device=dev).float() * 2.0 - 1.0
        self.type_means = base[None, :] * torch.where(de[None, :], 2.0 ** (signs * 6.0), 1.0)

    def _gen(self, t: int) -> torch.Generator:
        g = torch.Generator(device=self.dev)
        g.manual_seed((self.fold_seed + t) % (1 << 63))
        return g

    def fold_into(self, t: int, out: torch.Tensor) -> None:
        """Fold t's B rows of expression into `out` (B, genes)."""
        g = self._gen(t)
        y = torch.randint(0, self.n_types, (self.B,), generator=g, device=self.dev)
        X = torch.exp(0.3 * torch.randn((self.B, self.n_genes), generator=g, device=self.dev))
        X *= torch.rand((self.B, self.n_genes), generator=g, device=self.dev) > 0.2
        X *= self.type_means[y]
        torch.mul(X, 1e6 / torch.clamp_min(X.sum(dim=1, keepdim=True), 1e-9), out=out)

    def group(self, t0: int, lanes: int) -> torch.Tensor:
        """Folds t0..t0+lanes-1 -> (lanes, B, genes) float32."""
        Xg = torch.empty((lanes, self.B, self.n_genes), device=self.dev)
        for i in range(lanes):
            self.fold_into(t0 + i, Xg[i])
        return Xg

    def planted(self, t: int) -> torch.Tensor:
        """Fold t's planted types (B,)."""
        return torch.randint(0, self.n_types, (self.B,), generator=self._gen(t), device=self.dev)
