"""2-D visualization embedding (~ visualization_SHARP, R/visualization_SHARP.R:31).

Counterpart of `sharp_tpu/analysis/embed.py`. Feature construction matches
the reference (:46-60): the embedding input is `[w * scale(x0), scale(viE)]`,
the wMetaC vote matrix fused with the ensemble-mean RP features; w >= 100
uses x0 only (+ jitter), w <= 0.01 viE only. PCA reduces to 50 dims when
wider (:65-69), on the host in numpy as in the JAX package, so t-SNE sees
the same input.

The reference calls Rtsne's Barnes-Hut t-SNE; here, as in the JAX package,
an exact t-SNE whose iteration is a few (n, n) passes on the device. Inputs
above `max_cells` (10,000, the size the reference visualizes,
R/plot_markers.R:136-143) are subsampled proportionally per cluster. At
10,000 cells each (n, n) float32 matrix is 400 MB, and about five are live
at once.

Random draws: the subsample and the jitter use `np.random.default_rng(seed)`
(the JAX package's indices); the initial layout, a threefry draw there, is
drawn here from a CPU `torch.Generator` seeded with `seed` (so both devices
start from the same layout), or injected as `Y0`.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from sharp_tpu_torch.types import SharpResult


def _zscore_cols(M: np.ndarray) -> np.ndarray:
    mu = M.mean(axis=0, keepdims=True)
    sd = M.std(axis=0, ddof=1, keepdims=True)
    return (M - mu) / np.where(sd > 1e-12, sd, 1.0)


def _pca(M: np.ndarray, dim: int) -> np.ndarray:
    Mc = M - M.mean(axis=0, keepdims=True)
    _, _, Vt = np.linalg.svd(Mc, full_matrices=False)
    return Mc @ Vt[:dim].T


def _binary_search_sigmas(D2: torch.Tensor, perplexity: float, max_iter: int = 50) -> torch.Tensor:
    """Per-point conditional P (n, n) with entropy == log(perplexity), by
    bisection on each row's precision beta. No host sync inside."""
    n = D2.shape[0]
    target = float(np.log(perplexity))
    eye = torch.eye(n, dtype=torch.bool, device=D2.device)

    def H_and_P(beta):
        logits = torch.where(eye, -torch.inf, -D2 * beta[:, None])
        P = torch.softmax(logits, dim=1)
        # the taken branch sees P > 1e-12 only, so log(P) is finite there
        H = -torch.where(P > 1e-12, P * torch.log(P), 0.0).sum(dim=1)
        return H, P

    beta = torch.ones(n, device=D2.device)
    lo = torch.zeros(n, device=D2.device)
    hi = torch.full((n,), torch.inf, device=D2.device)
    for _ in range(max_iter):
        H, _ = H_and_P(beta)
        too_high = H > target  # entropy too high -> increase beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, 0.5 * (lo + hi))
    _, P = H_and_P(beta)
    return P


def _joint_p(X: torch.Tensor, perplexity: float) -> torch.Tensor:
    """The symmetric joint P of t-SNE for the rows of X (n, d)."""
    n = X.shape[0]
    sq = (X * X).sum(dim=1)
    D2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T), 0.0)
    Pc = _binary_search_sigmas(D2, perplexity)
    return torch.clamp_min((Pc + Pc.T) / (2.0 * n), 1e-12)


def _tsne_exact(
    X: torch.Tensor,
    Y0: torch.Tensor,
    perplexity: float = 30.0,
    n_iter: int = 500,
    exaggeration_iters: int = 100,
    lr: float = 200.0,
) -> torch.Tensor:
    """Exact t-SNE of the rows of X (n, d) from the layout Y0 (n, 2), both
    on one device: `n_iter` steps of momentum gradient descent with early
    exaggeration. A Python loop with no host sync inside."""
    n = X.shape[0]
    P = _joint_p(X, perplexity)
    eye = torch.eye(n, dtype=torch.bool, device=X.device)
    Y, V = Y0, torch.zeros_like(Y0)
    for i in range(n_iter):
        sqy = (Y * Y).sum(dim=1)
        num = 1.0 / (1.0 + torch.clamp_min(sqy[:, None] + sqy[None, :] - 2.0 * (Y @ Y.T), 0.0))
        num = torch.where(eye, 0.0, num)
        Q = torch.clamp_min(num / num.sum(), 1e-12)
        early = i < exaggeration_iters
        PQ = (P * (12.0 if early else 1.0) - Q) * num
        # (diag(rowsum(PQ)) - PQ) @ Y without the (n, n) diagonal matrix
        grad = 4.0 * (PQ.sum(dim=1)[:, None] * Y - PQ @ Y)
        V = (0.5 if early else 0.8) * V - lr * grad
        Y = Y + V
        Y = Y - Y.mean(dim=0, keepdim=True)
    return Y


def initial_layout(n: int, seed: int) -> torch.Tensor:
    """The start layout, 1e-4 * N(0, 1) of shape (n, 2), from a CPU
    `torch.Generator` seeded with `seed` (the same on every device)."""
    g = torch.Generator().manual_seed(seed)
    return 1e-4 * torch.randn((n, 2), generator=g)


def embedding_input(
    y: Union[SharpResult, Tuple[np.ndarray, np.ndarray]],
    *,
    w: float = 2.0,
    seed: int = 10,
    max_cells: int = 10000,
) -> Tuple[np.ndarray, np.ndarray]:
    """The t-SNE input on the host: (X (m, <= 50) float, cell_indices (m,)),
    the fused, z-scored view features of the (subsampled) cells, reduced by
    PCA when wider than 50."""
    if isinstance(y, SharpResult):
        x0, viE, labels = y.x0, y.viE, y.pred_clusters
    else:
        x0, viE = y
        labels = None
    if x0 is None and viE is None:
        raise ValueError("need x0 and/or viE (run sharp with forview=True)")

    parts = []
    if w >= 100 or viE is None:
        rng = np.random.default_rng(seed)
        parts.append(
            w * _zscore_cols(np.asarray(x0))
            + 1e-3 * rng.normal(size=np.asarray(x0).shape)
        )
    elif w <= 0.01 or x0 is None:
        parts.append(_zscore_cols(np.asarray(viE)))
    else:
        parts.append(w * _zscore_cols(np.asarray(x0)))
        parts.append(_zscore_cols(np.asarray(viE)))
    X = np.concatenate(parts, axis=1).astype(np.float32)
    # drop all-constant columns (z-score left them 0)
    keep = X.std(axis=0) > 0
    X = X[:, keep] if keep.any() else X

    n = X.shape[0]
    idx = np.arange(n)
    if n > max_cells:
        rng = np.random.default_rng(seed)
        if labels is not None:
            sel = []
            for c in np.unique(labels):
                ci = np.flatnonzero(labels == c)
                take = max(int(round(len(ci) / n * max_cells)), 1)
                sel.append(rng.choice(ci, min(take, len(ci)), replace=False))
            idx = np.sort(np.concatenate(sel))
        else:
            idx = np.sort(rng.choice(n, max_cells, replace=False))
        X = X[idx]

    if X.shape[1] > 50:
        X = _pca(X, 50)
    return X, idx


def visualization_embedding(
    y: Union[SharpResult, Tuple[np.ndarray, np.ndarray]],
    *,
    w: float = 2.0,
    perplexity: float = 30.0,
    n_iter: int = 500,
    seed: int = 10,
    max_cells: int = 10000,
    Y0: Optional[np.ndarray] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Embed the clustering result in 2-D on `device`.

    Returns (embedding (m, 2), cell_indices (m,)); the indices identify the
    subsample when n > max_cells (proportional per cluster, mirroring
    R/plot_markers.R:136-143). `Y0` (m, 2) injects the start layout
    (`sharp_tpu_torch.carry.tsne_layout_from_jax` carries the JAX package's).
    """
    from sharp_tpu_torch.api import resolve_device

    dev = resolve_device(device)
    X, idx = embedding_input(y, w=w, seed=seed, max_cells=max_cells)
    Y0 = initial_layout(len(idx), seed) if Y0 is None else torch.as_tensor(Y0, dtype=torch.float32)
    if tuple(Y0.shape) != (len(idx), 2):
        raise ValueError(f"Y0 has shape {tuple(Y0.shape)}, expected ({len(idx)}, 2)")
    Xt = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
    emb = _tsne_exact(Xt, Y0.to(dev), perplexity=perplexity, n_iter=n_iter)
    return emb.cpu().numpy(), idx
