"""Very-sparse ternary random projection.

Counterpart of `sharp_tpu/ops/rp.py`. Entries of the m x p matrix are
{+sqrt(s), 0, -sqrt(s)} with probabilities {1/(2s), 1 - 1/s, 1/(2s)},
s = sqrt(m) (R/ranM.R:17-30), and the projection is scaled by 1/sqrt(p)
(R/RPmat.R:32). The K ensemble members are stacked into one (m, K*p)
operand so the cells are read once per projection; log2(1+x) is applied
to the input inside the projection call, so the call is the whole RP stage.

The route follows R's dtype, as the JAX package's `jnp.dot(...,
preferred_element_type=float32)` does:

* bfloat16 or float16 R on the card: the operand kernel
  (`csrc/rp_operand.cu`, `rp_operand`) makes the cells' operand in R's
  dtype in one pass (log2, rounding, the gene axis padded with zeros to a
  multiple of 8), and `torch.mm(..., out_dtype=torch.float32)` multiplies
  on the tensor cores with float32 sums and output (R's rows padded to
  match, once for each R). A product of two 16-bit values is exact in
  float32, so only the order of the sums differs from the float32 route.
* any other R (float32, or the benchmark's float8 control), and every CPU
  tensor: the cells rounded to R's dtype, then a float32 `torch.matmul`.

Either route ends in one pass that applies the 1/sqrt(p) scale (a cached
device scalar: no upload, no synchronise a call) and the (K, n, p) layout.
While tracing, the rows each route projected are counted
(`rp.tensor_core_rows`, `rp.float32_rows` in `timers.snapshot()["sums"]`).
"""

from __future__ import annotations

import threading
import weakref

import torch
import torch.nn.functional as F

from sharp_tpu_torch.utils.prng import member_generator
from sharp_tpu_torch.utils.timers import add

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


# RP dtypes whose product runs on the tensor cores, and the operand
# kernel's code for each
_TENSOR_CORE = {torch.bfloat16: 0, torch.float16: 1}
# launches of the operand kernel; on the card only
LAUNCHES = {"rp_operand": 0}
_LAUNCHES_LOCK = threading.Lock()
# 1/sqrt(p) by (p, device): made once, as the product's scale always was
_SCALES = {}
_SCALES_LOCK = threading.Lock()
# R with its rows padded to the operand's, by device: (weak reference to
# R, R's version, padded R); dropped when R is
_PADDED = {}


def rp_operand_plain(X: torch.Tensor, dtype: torch.dtype, log_transform: bool, cols_pad: int) -> torch.Tensor:
    """The operand kernel's plain version: `log2p1(X).to(dtype)` (or
    `X.to(dtype)`), the columns padded with zeros to `cols_pad`."""
    Xc = log2p1(X) if log_transform else X
    return F.pad(Xc.to(dtype), (0, cols_pad - X.shape[1]))


def _rp_operand_cuda(X: torch.Tensor, dtype: torch.dtype, log_transform: bool, cols_pad: int) -> torch.Tensor:
    """The operand kernel's launch, the CUDA kernel of `sharp::rp_operand`."""
    from sharp_tpu_torch.ops._build import load_kernels

    out = torch.empty((X.shape[0], cols_pad), dtype=dtype, device=X.device)
    lib = load_kernels()["rp_operand.cu"]
    rc = lib.sharp_rp_operand_launch(
        X.data_ptr(), out.data_ptr(), X.shape[0], X.shape[1], cols_pad, int(log_transform),
        _TENSOR_CORE[dtype], torch.cuda.current_stream(X.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"rp_operand kernel launch failed with cudaError_t {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES["rp_operand"] += 1
    return out


# The launch as an operator of its own: the profiler then ties the kernel
# to a host operation, as it ties aten's, and a span around the call holds
# the kernel's device time. A plain dispatcher registration: no tracing
# machinery is imported on the first call.
_OPS = torch.library.Library("sharp", "DEF")
_OPS.define("rp_operand(Tensor X, ScalarType dtype, bool log_transform, int cols_pad) -> Tensor")
_OPS.impl("rp_operand", _rp_operand_cuda, "CUDA")


def rp_operand(X: torch.Tensor, dtype: torch.dtype, log_transform: bool) -> torch.Tensor:
    """The RP product's operand of float32 cells X (n, genes): (n, genes
    padded to a multiple of 8) in `dtype` (bfloat16 or float16), log2(1 + x)
    first when `log_transform`, the pad columns zero. On the card the
    operand kernel makes it in one pass; on the CPU the plain version."""
    cols_pad = -(-X.shape[1] // 8) * 8
    if X.device.type == "cpu":
        return rp_operand_plain(X, dtype, log_transform, cols_pad)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device} (cpu or cuda)")
    if X.dtype != torch.float32 or dtype not in _TENSOR_CORE:
        raise TypeError(f"rp_operand takes float32 cells to bfloat16 or float16, not {X.dtype} to {dtype}")
    if X.dim() != 2 or not X.is_contiguous():
        raise ValueError("rp_operand takes a contiguous (n, genes) matrix")
    return torch.ops.sharp.rp_operand(X, dtype, log_transform, cols_pad)


def _scale(p: int, device: torch.device) -> torch.Tensor:
    """1/sqrt(p) as a 0-d float32 tensor on `device`, by the device's
    rsqrt; made on the first call for (p, device), which waits for it so
    that every thread's stream may read it."""
    key = (p, device)
    s = _SCALES.get(key)
    if s is None:
        with _SCALES_LOCK:
            s = _SCALES.get(key)
            if s is None:
                s = torch.tensor(float(p), dtype=torch.float32, device=device).rsqrt()
                if device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
                _SCALES[key] = s
    return s


def _padded_rows(R: torch.Tensor, rows: int) -> torch.Tensor:
    """R (m, K*p) with zero rows appended up to `rows`, made once for each
    R (and again if R is written in place) and kept while R lives: R_all
    is fixed for a run and multiplied once a fold group."""
    if R.shape[0] == rows:
        return R
    key = R.device
    hit = _PADDED.get(key)
    if hit is not None and hit[0]() is R and hit[1] == R._version:
        return hit[2]

    def drop(ref, key=key):
        if _PADDED.get(key, (None,))[0] is ref:
            _PADDED.pop(key, None)

    Rp = F.pad(R, (0, 0, 0, rows - R.shape[0]))
    _PADDED[key] = (weakref.ref(R, drop), R._version, Rp)
    return Rp


def _project(X: torch.Tensor, R: torch.Tensor, K: int, log_transform: bool) -> torch.Tensor:
    """X (n, m) by the stacked R (m, K*p), scaled by 1/sqrt(p) -> (K, n, p)."""
    n, m = X.shape
    p = R.shape[1] // K
    if X.device.type == "cuda" and R.dtype in _TENSOR_CORE:
        Xb = rp_operand(X, R.dtype, log_transform)
        # float32 sums and output; cuBLAS's reduced-precision reduction
        # flags leave this product as it is (bit for bit, a cuda test)
        out = torch.mm(Xb, _padded_rows(R, Xb.shape[1]), out_dtype=torch.float32)
        del Xb
        add("rp.tensor_core_rows", n)
    else:
        Xc = log2p1(X) if log_transform else X
        # inputs rounded to the compute dtype, product and output in float32
        out = torch.matmul(Xc.to(R.dtype).float(), R.float())
        add("rp.float32_rows", n)
    return torch.mul(out.view(n, K, p).transpose(0, 1), _scale(p, X.device),
                     out=torch.empty((K, n, p), dtype=torch.float32, device=X.device))


def rp_project(
    X: torch.Tensor, R: torch.Tensor, *, log_transform: bool = False
) -> torch.Tensor:
    """Project cells-by-genes X (n, m) with RP matrix R (m, p) -> (n, p)."""
    return _project(X, R, 1, log_transform)[0]


def rp_project_ensemble(
    X: torch.Tensor, R_all: torch.Tensor, *, K: int, log_transform: bool = False
) -> torch.Tensor:
    """Project X (n, m) with the stacked (m, K*p) ensemble -> (K, n, p)."""
    return _project(X, R_all, K, log_transform)
