"""Carry the JAX package's random draws into the port.

The system has no trained weights; what fixes a run besides the data are
its random draws: the stacked ensemble RP matrix, the testlog probe (the
cell permutation and the fixed-seed probe RP matrix,
`sharp_tpu/core/pipeline.py:71-81`), on the large tier the cell
reshuffle before the fold partition (`sharp_tpu/core/large.py:428-434`),
and the t-SNE start layout of the embedding (`sharp_tpu/analysis/embed.py:89`). `torch.Generator` cannot reproduce
JAX's threefry streams, so a comparison between the two packages makes
these arrays once (with the JAX package, or with numpy) and hands them to
the port as numpy arrays through the functions here. Like every entry
point of the port, they put their tensors on the card unless the caller
asks for the CPU (`device="cpu"`).
"""

from __future__ import annotations

import numpy as np
import torch

from sharp_tpu_torch.core.pipeline import TestlogProbe


def rp_from_jax(R_all: np.ndarray, K: int, p: int, device="cuda") -> torch.Tensor:
    """The stacked (genes, K*p) ensemble RP matrix as the port's tensor."""
    R = np.asarray(R_all)
    if R.ndim != 2 or R.shape[1] != K * p:
        raise ValueError(f"R_all has shape {R.shape}, expected (genes, {K * p}) for K={K}, p={p}")
    return torch.from_numpy(np.array(R, dtype=np.float32)).to(device)


def testlog_probe_from_jax(
    perm: np.ndarray, R_probe: np.ndarray, n: int, genes: int, p: int, device="cuda"
) -> TestlogProbe:
    """The testlog probe: `perm` a permutation of the n cells (the JAX
    package's `jax.random.permutation(testlog_key(key), n)`), `R_probe`
    the (genes, p) probe RP matrix (its `ternary_rp_matrix(PRNGKey(5),
    genes, p)`)."""
    perm = np.asarray(perm)
    R = np.asarray(R_probe)
    if perm.shape != (n,) or not np.array_equal(np.sort(perm), np.arange(n)):
        raise ValueError(f"perm must be a permutation of {n} cells, got shape {perm.shape}")
    if R.shape != (genes, p):
        raise ValueError(f"R_probe has shape {R.shape}, expected ({genes}, {p})")
    return TestlogProbe(
        perm=torch.from_numpy(np.array(perm, dtype=np.int64)).to(device),
        R=torch.from_numpy(np.array(R, dtype=np.float32)).to(device),
    )


def tsne_layout_from_jax(Y0: np.ndarray, n: int, device="cuda") -> torch.Tensor:
    """The t-SNE start layout: `Y0` the (n, 2) array of the JAX package's
    `1e-4 * jax.random.normal(PRNGKey(seed), (n, 2))`, as the port's float32
    tensor (`visualization_embedding(..., Y0=...)`)."""
    Y0 = np.asarray(Y0)
    if Y0.shape != (n, 2):
        raise ValueError(f"Y0 has shape {Y0.shape}, expected ({n}, 2)")
    return torch.from_numpy(np.array(Y0, dtype=np.float32)).to(device)


def shuffle_perm_from_jax(perm: np.ndarray, n: int) -> torch.Tensor:
    """The large tier's cell reshuffle: `perm` a permutation of the n cells
    (the JAX package's `jax.random.permutation(shuffle_key(key), n,
    independent=True)`), as a CPU int64 tensor."""
    perm = np.asarray(perm)
    if perm.shape != (n,) or not np.array_equal(np.sort(perm), np.arange(n)):
        raise ValueError(f"perm must be a permutation of {n} cells, got shape {perm.shape}")
    return torch.from_numpy(np.array(perm, dtype=np.int64))
