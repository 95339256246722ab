"""Per-cluster expression split (~ get_percluster_exp, R/get_percluster_exp.R:24).

Counterpart of `sharp_tpu/analysis/percluster.py`, numpy only.

The reference returns one sparse matrix per cluster assembled with a
two-level foreach + NULL-safe cbind combiner; here it's a dict of row
slices. Accepts blocked input (list of matrices) like the reference.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from sharp_tpu_torch.types import SharpResult


def get_percluster_exp(
    X: Union[np.ndarray, Sequence[np.ndarray]],
    y: Union[SharpResult, np.ndarray],
) -> Dict[int, np.ndarray]:
    """Split cells-by-genes X (or list of row-blocks) by cluster label."""
    labels = np.asarray(
        y.pred_clusters if isinstance(y, SharpResult) else y
    )
    if isinstance(X, (list, tuple)):
        X = np.concatenate([np.asarray(b) for b in X], axis=0)
    X = np.asarray(X)
    if X.shape[0] != labels.shape[0]:
        raise ValueError("X rows and labels must align (cells x genes)")
    return {int(c): X[labels == c] for c in np.unique(labels)}
