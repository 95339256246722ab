"""Rand-family clustering agreement metrics: the port's copy of
`sharp_tpu/analysis/ari.py`.

The reference's ARI() (R/ARI.R:20-42) factor-encodes truth and prediction
and reports five metrics: Rand, HA (Hubert-Arabie, "the" ARI), MA
(Morey-Agresti), FM (Fowlkes-Mallows) and Jaccard. All come in closed form
from the contingency table, on the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _comb2(x):
    return x * (x - 1.0) / 2.0


def rand_metrics(truth, pred) -> Dict[str, float]:
    truth = np.asarray(truth)
    pred = np.asarray(pred)
    if truth.shape != pred.shape:
        raise ValueError("truth and pred must have the same length")
    n = truth.size
    _, ti = np.unique(truth, return_inverse=True)
    _, pi = np.unique(pred, return_inverse=True)
    table = np.zeros((ti.max() + 1, pi.max() + 1), np.float64)
    np.add.at(table, (ti, pi), 1.0)

    a = table.sum(axis=1)
    b = table.sum(axis=0)
    T = _comb2(table).sum()
    A = _comb2(a).sum()
    B = _comb2(b).sum()
    N = _comb2(np.float64(n))

    rand = (N + 2 * T - A - B) / N
    exp = A * B / N
    ha = (T - exp) / (0.5 * (A + B) - exp) if (0.5 * (A + B) - exp) != 0 else 1.0
    # Morey & Agresti 1984: the same adjustment with the sum-of-squares
    # approximation of the expected index
    P = (table**2).sum()
    Pa = (a**2).sum()
    Pb = (b**2).sum()
    exp_ma = Pa * Pb / n**2
    denom_ma = 0.5 * (Pa + Pb) - exp_ma
    ma = (P - exp_ma) / denom_ma if denom_ma != 0 else 1.0
    fm = T / np.sqrt(A * B) if A > 0 and B > 0 else 0.0
    jaccard = T / (A + B - T) if (A + B - T) > 0 else 0.0
    return {
        "Rand": float(rand),
        "HA": float(ha),
        "MA": float(ma),
        "FM": float(fm),
        "Jaccard": float(jaccard),
    }


def ari(truth, pred) -> float:
    """The Hubert-Arabie adjusted Rand index (the reference's headline
    metric)."""
    return rand_metrics(truth, pred)["HA"]
