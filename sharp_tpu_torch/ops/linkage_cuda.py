"""Wrappers of the hand-written Hopper kernels: serial Ward, the ladder tail and the cut replay.

Counterpart of `sharp_tpu/ops/linkage_pallas.py`, with the same public
names where a TPU kernel has a port:

    ward_linkage_pallas  -> ward_linkage_serial   (csrc/ward_serial.cu)
    cutree_multi_pallas  -> cutree_multi_kernel   (csrc/cutree.cu)
    rnn_tail_pallas      -> rnn_tail_kernel       (csrc/rnn_tail.cu)

A wrapper launches its kernel for a CUDA tensor and takes the kernel's
plain version (`ops/linkage.py`) only for a CPU tensor; any other device,
dtype, shape or layout raises. Launches go on the current CUDA stream and
do not synchronise. Each launching wrapper counts its launches in a plain
integer attribute, `<wrapper>.launches`.
"""

from __future__ import annotations

import torch

from sharp_tpu_torch.ops.linkage import (
    SERIAL_MAX_N,
    CutForest,
    LinkageResult,
    cut_forest,
    cutree_snapshots,
    rnn_tail,
    ward_linkage,
    counts_per_problem,
)

# the cut replay stages merges + labels (3n int32) in 48 KB of shared memory
CUTREE_MAX_N = 4096
# the tail kernel drains one lane per thread block of at most 1024 threads
RNN_TAIL_MAX_N = 1024
_TAIL_STORE = {torch.float32: 0, torch.bfloat16: 1}


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device} (cpu or cuda)")
    return x.device.type


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with cudaError_t {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ward_linkage_serial(D: torch.Tensor) -> LinkageResult:
    """Batched exact-f32 serial Ward.D over D (K, n, n) or (n, n).

    Same contract and bit-identical output as `ops.linkage.ward_linkage`
    (merges (..., n-1, 2) int32 with col 0 the survivor, heights float32).
    """
    if _device_kind(D) == "cpu":
        return ward_linkage(D, method="ward.D")
    if D.dtype != torch.float32:
        raise TypeError(f"ward_linkage_serial takes float32, got {D.dtype}")
    if D.dim() not in (2, 3) or D.shape[-1] != D.shape[-2]:
        raise ValueError(f"ward_linkage_serial takes (K, n, n) or (n, n), got {tuple(D.shape)}")
    if not D.is_contiguous():
        raise ValueError("ward_linkage_serial takes a contiguous D")
    n = D.shape[-1]
    if not 2 <= n <= SERIAL_MAX_N:
        raise ValueError(f"ward_linkage_serial takes 2 <= n <= {SERIAL_MAX_N}, got {n}")
    from sharp_tpu_torch.ops._build import load_kernels

    lib = load_kernels()["ward_serial.cu"]
    squeeze = D.dim() == 2
    W = torch.empty((1 if squeeze else D.shape[0], n, n), dtype=torch.float32, device=D.device)
    W.copy_(D.reshape(W.shape))   # the kernel updates its matrix in place
    K = W.shape[0]
    merges = torch.empty((K, n - 1, 2), dtype=torch.int32, device=D.device)
    heights = torch.empty((K, n - 1), dtype=torch.float32, device=D.device)
    rc = lib.sharp_ward_serial_launch(
        W.data_ptr(), merges.data_ptr(), heights.data_ptr(), K, n, _stream()
    )
    _check_rc(rc, "ward_serial")
    ward_linkage_serial.launches += 1
    if squeeze:
        return LinkageResult(merges[0], heights[0])
    return LinkageResult(merges, heights)


ward_linkage_serial.launches = 0


def rnn_tail_kernel(
    D: torch.Tensor, alive: torch.Tensor, sizes: torch.Tensor,
    gidx: torch.Tensor, lasth: torch.Tensor,
):
    """Serial-drain the ladder's compacted subproblems D (L, Cn, Cn),
    float32 or bfloat16 storage, alive/sizes/lasth (L, Cn) float32 and
    gidx (L, Cn) int32 -> mi, mj (L, Cn) int32, hh (L, Cn) float32.

    Same contract as `ops.linkage.rnn_tail`; for t < n_alive - 1 the output
    is identical to it. The kernel stops each lane after its n_alive - 1
    merges and leaves zeros in the entries after them.
    """
    if _device_kind(D) == "cpu":
        return rnn_tail(D, alive, sizes, gidx, lasth)
    if D.dtype not in _TAIL_STORE:
        raise TypeError(f"rnn_tail_kernel stores float32 or bfloat16, got {D.dtype}")
    if D.dim() != 3 or D.shape[1] != D.shape[2]:
        raise ValueError(f"rnn_tail_kernel takes D (L, Cn, Cn), got {tuple(D.shape)}")
    L, Cn, _ = D.shape
    if not 2 <= Cn <= RNN_TAIL_MAX_N:
        raise ValueError(f"rnn_tail_kernel takes 2 <= Cn <= {RNN_TAIL_MAX_N}, got {Cn}")
    for name, x, dt in (("alive", alive, torch.float32), ("sizes", sizes, torch.float32),
                        ("gidx", gidx, torch.int32), ("lasth", lasth, torch.float32)):
        if x.dtype != dt or tuple(x.shape) != (L, Cn) or x.device != D.device:
            raise ValueError(
                f"rnn_tail_kernel takes {name} ({L}, {Cn}) {dt} on {D.device}, got "
                f"{tuple(x.shape)} {x.dtype} on {x.device}"
            )
    from sharp_tpu_torch.ops._build import load_kernels

    lib = load_kernels()["rnn_tail.cu"]
    W = D.contiguous().clone()   # the kernel updates its matrix in place
    state = [x.contiguous() for x in (alive, sizes, gidx, lasth)]
    mi = torch.empty((L, Cn), dtype=torch.int32, device=D.device)
    mj = torch.empty((L, Cn), dtype=torch.int32, device=D.device)
    hh = torch.empty((L, Cn), dtype=torch.float32, device=D.device)
    rc = lib.sharp_rnn_tail_launch(
        W.data_ptr(), *(x.data_ptr() for x in state),
        mi.data_ptr(), mj.data_ptr(), hh.data_ptr(),
        L, Cn, _TAIL_STORE[D.dtype], _stream(),
    )
    _check_rc(rc, "rnn_tail")
    rnn_tail_kernel.launches += 1
    return mi, mj, hh


rnn_tail_kernel.launches = 0


def cutree_snapshots_kernel(
    merges: torch.Tensor, n_real, *, minN: int, ncand: int
) -> torch.Tensor:
    """Replay merges (G, n-1, 2) and snapshot labels at every candidate cut
    -> (G, ncand, n) int32. Same contract as `ops.linkage.cutree_snapshots`."""
    if _device_kind(merges) == "cpu":
        return cutree_snapshots(merges, n_real, minN=minN, ncand=ncand)
    if merges.dtype != torch.int32:
        raise TypeError(f"cutree takes int32 merges, got {merges.dtype}")
    if merges.dim() != 3 or merges.shape[-1] != 2:
        raise ValueError(f"cutree takes merges (G, n-1, 2), got {tuple(merges.shape)}")
    if not merges.is_contiguous():
        raise ValueError("cutree takes contiguous merges")
    G, m, _ = merges.shape
    n = m + 1
    if not 2 <= n <= CUTREE_MAX_N:
        raise ValueError(f"cutree takes 2 <= n <= {CUTREE_MAX_N}, got {n}")
    if ncand < 1:
        raise ValueError(f"cutree takes ncand >= 1, got {ncand}")
    nr = counts_per_problem(n_real, G, merges.device)
    from sharp_tpu_torch.ops._build import load_kernels

    lib = load_kernels()["cutree.cu"]
    snaps = torch.empty((G, ncand, n), dtype=torch.int32, device=merges.device)
    rc = lib.sharp_cutree_launch(
        merges.data_ptr(), nr.data_ptr(), snaps.data_ptr(), G, n, minN, ncand, _stream()
    )
    _check_rc(rc, "cutree")
    cutree_snapshots_kernel.launches += 1
    return snaps


cutree_snapshots_kernel.launches = 0


def cutree_multi_kernel(
    merges: torch.Tensor,
    n_real,
    real_mask: torch.Tensor,
    maxN,
    *,
    minN: int,
    ncand: int,
    nc_pad: int,
) -> CutForest:
    """All cuts k = minN..minN+ncand-1 through the replay kernel; the dense
    relabelling and the validity mask run in torch, as in the JAX wrapper.
    Same contract as `ops.linkage.cutree_multi`."""
    squeeze = merges.dim() == 2
    mg = merges[None] if squeeze else merges
    snaps = cutree_snapshots_kernel(mg.contiguous(), n_real, minN=minN, ncand=ncand)
    out = cut_forest(
        snaps, n_real, real_mask, maxN, minN=minN, ncand=ncand, nc_pad=nc_pad
    )
    return CutForest(*(x[0] for x in out)) if squeeze else out
