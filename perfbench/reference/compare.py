"""The comparison that decides `correct`: the numbers that hold the
program's outputs against the reference's, each with its limit.

Plain numpy; imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np


def ari(a, b) -> float:
    """Adjusted Rand index of two labellings of the same cells."""
    a = np.unique(np.asarray(a), return_inverse=True)[1]
    b = np.unique(np.asarray(b), return_inverse=True)[1]
    table = np.zeros((a.max() + 1, b.max() + 1), np.int64)
    np.add.at(table, (a, b), 1)

    def pairs(x):
        x = np.asarray(x, np.float64)
        return float((x * (x - 1) / 2).sum())

    n = len(a)
    s, sa, sb = pairs(table), pairs(table.sum(1)), pairs(table.sum(0))
    expected = sa * sb / (n * (n - 1) / 2) if n > 1 else 0.0
    top = 0.5 * (sa + sb)
    return 1.0 if top == expected else (s - expected) / (top - expected)


def label_gap(prog, ref) -> float:
    """1 - ARI: 0 where the two partitions are the same."""
    return max(0.0, 1.0 - ari(prog, ref))


def rel_err(prog, ref) -> float:
    """Relative Frobenius distance of the program's array from the reference's."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(prog - ref) / max(np.linalg.norm(ref), 1e-30))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number passes at or below it."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"numbers not computed: {sorted(missing)}")
    return {k: {"value": float(numbers[k]), "limit": float(limits[k]),
                "ok": bool(numbers[k] <= limits[k])} for k in limits}


def worst(values: Iterable[float]) -> float:
    vals = [float(v) for v in values]
    return max(vals) if vals else 0.0
