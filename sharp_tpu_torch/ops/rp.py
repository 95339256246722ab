"""Very-sparse ternary random projection.

Counterpart of `sharp_tpu/ops/rp.py`. Entries of the m x p matrix are
{+sqrt(s), 0, -sqrt(s)} with probabilities {1/(2s), 1 - 1/s, 1/(2s)},
s = sqrt(m) (R/ranM.R:17-30), and the projection is scaled by 1/sqrt(p)
(R/RPmat.R:32). The K ensemble members are stacked into one (m, K*p)
operand so the cells are read once per projection; log2(1+x) is applied
to the input right before the product. The product itself is a plain
`torch.matmul` in float32.
"""

from __future__ import annotations

import threading

import torch

from sharp_tpu_torch.utils.prng import member_generator

# float dtypes whose torch.log2 has run once in this process on one CPU thread
_LOG2_READY = set()
_LOG2_LOCK = threading.Lock()


def log2p1(x: torch.Tensor) -> torch.Tensor:
    """log2(1 + x), as `torch.log2(1.0 + x)`: the log transform of the dense
    feed, the sparse feed and the projection.

    On the CPU, torch takes the log2 of a float tensor with MKL's vector
    math, in chunks over its OpenMP threads. When a process's first such
    call ran on several threads at once, one thread's whole chunk could
    come back up to ~890 float32 ulps off (the intermittent mismatch of the
    sparse feed against the JAX package). So the first call of a process
    for each dtype is made on one element, on the calling thread, before
    any other; the result is the same function.
    """
    if x.device.type == "cpu" and x.dtype not in _LOG2_READY:
        with _LOG2_LOCK:
            if x.dtype not in _LOG2_READY:
                torch.log2(torch.ones(1, dtype=x.dtype))
                _LOG2_READY.add(x.dtype)
    return torch.log2(1.0 + x)


def ternary_rp_matrix(
    gen: torch.Generator, m: int, p: int, dtype=torch.float32
) -> torch.Tensor:
    """Sample an (m, p) ternary very-sparse RP matrix from `gen`, on the
    generator's device.

    Entries: +/- sqrt(s) w.p. 1/(2s) each, 0 otherwise, s = sqrt(m)
    (R/ranM.R:17-24). E[r^2] = 1, so 1/sqrt(p) * R^T x preserves distances.
    """
    device = gen.device
    s = torch.sqrt(torch.tensor(float(m), dtype=torch.float32, device=device))
    root_s = torch.sqrt(s)
    u = torch.rand((m, p), generator=gen, dtype=torch.float32, device=device)
    thresh = 1.0 / (2.0 * s)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    r = torch.where(u < thresh, root_s, torch.where(u > 1.0 - thresh, -root_s, zero))
    return r.to(dtype)


def ensemble_rp_matrix(
    rN_seed: int, K: int, m: int, p: int, dtype=torch.float32, device="cuda"
) -> torch.Tensor:
    """All K ensemble RP matrices stacked to (m, K*p), member k drawn from
    its own stream (`member_generator`), on `device` (a CUDA request
    without a card raises, `api.resolve_device`)."""
    from sharp_tpu_torch.api import resolve_device

    device = resolve_device(device)
    cols = [
        ternary_rp_matrix(member_generator(rN_seed, k, device), m, p, dtype)
        for k in range(K)
    ]
    return torch.cat(cols, dim=1)


def _project(X: torch.Tensor, R: torch.Tensor, p: int, log_transform: bool):
    Xc = log2p1(X) if log_transform else X
    # inputs rounded to the compute dtype, product and output in float32
    # (the JAX package's preferred_element_type=float32)
    out = torch.matmul(Xc.to(R.dtype).float(), R.float())
    scale = torch.tensor(float(p), dtype=torch.float32, device=X.device).rsqrt()
    return out * scale


def rp_project(
    X: torch.Tensor, R: torch.Tensor, *, log_transform: bool = False
) -> torch.Tensor:
    """Project cells-by-genes X (n, m) with RP matrix R (m, p) -> (n, p)."""
    return _project(X, R, R.shape[1], log_transform)


def rp_project_ensemble(
    X: torch.Tensor, R_all: torch.Tensor, *, K: int, log_transform: bool = False
) -> torch.Tensor:
    """Project X (n, m) with the stacked (m, K*p) ensemble -> (K, n, p)."""
    n = X.shape[0]
    p = R_all.shape[1] // K
    out = _project(X, R_all, p, log_transform)
    return out.reshape(n, K, p).permute(1, 0, 2).contiguous()
