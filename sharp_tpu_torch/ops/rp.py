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

import torch

from sharp_tpu_torch.utils.prng import member_generator


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
    Xc = torch.log2(1.0 + X) if log_transform else X
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
