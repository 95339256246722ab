"""Wrappers of the hand-written Hopper kernels: serial Ward, the ladder's
rounds and tail, and the cut replay.

Counterpart of `sharp_tpu/ops/linkage_pallas.py`; each TPU kernel has its
port:

    ward_linkage_pallas  -> ward_linkage_serial   (csrc/ward_serial.cu)
    cutree_multi_pallas  -> cutree_multi_kernel   (csrc/cutree.cu)
    rnn_tail_pallas      -> rnn_tail_kernel       (csrc/rnn_tail.cu)
    rnn_round_scatter    -> rnn_round_kernel      (csrc/rnn_round.cu: the
                            whole round, the pairs' selection and fresh rows
                            in `rnn_pairs_*`, the scatter in
                            `rnn_round_scatter`)

A wrapper launches its kernel for a CUDA tensor and takes the kernel's
plain version (`ops/linkage.py`) only for a CPU tensor; any other device,
dtype, shape or layout raises. Launches go on the current CUDA stream and
do not synchronise. Each wrapper adds one to its kernel's entry of
`LAUNCHES` (the round's wrapper to "rnn_pairs" and "rnn_round", the two
parts of its round), and the problems or lanes it launched to its entry of
`PROBLEMS`, where it launches the kernel, and nowhere else, under a lock:
the shards of `parallel/sharded.py` launch from several threads.

While a profiler records, the round's and the cut replay's wrappers also
go through the tracer (`utils/timers`): the cut replay's bytes
(`cutree_bytes`, on the CPU too), and a CUDA event pair around each launch
call of the round (`timers.kernel`), with the arguments built before it,
read by `timers.snapshot()`. The cut replay gets no event pair: its kernel
(~11 us a launch at (80, 2048)) ends before the host records the end
event, so a pair would time the wrapper's host path.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from sharp_tpu_torch.ops.linkage import (
    CutForest,
    LinkageResult,
    cut_forest,
    cutree_snapshots,
    rnn_round,
    rnn_tail,
    ward_linkage,
    counts_per_problem,
)
from sharp_tpu_torch.utils.timers import add, kernel

# the cut replay keeps its state (2n int32) in shared memory up to the 227 KB
# a block may opt in to, above that in a global scratch
CUTREE_SMEM_MAX_N = 232448 // 8
# the tail kernel drains one lane per thread block of at most 1024 threads;
# up to Cn 256 (WARD_TILE_MAX_N) a symmetric lane's matrix sits in shared
# memory as its packed upper triangle
RNN_TAIL_MAX_N = 1024
# serial Ward keeps the packed triangle in shared memory up to n 256
# (kTileMaxN in csrc/ward_tile.cuh), above that the matrix in global
# memory and seven words per row in shared memory up to n 8192 (225 KB,
# kStateSmemMaxN), above that in a global scratch
WARD_TILE_MAX_N = 256
WARD_STATE_SMEM_MAX_N = 8192
# storage type codes of the kernels that store float32 or bfloat16
_STORE = {torch.float32: 0, torch.bfloat16: 1}
# launches of each kernel, keyed by the kernel's name; owned by this module,
# so a wrapper replaced by a test double does not take the count with it
LAUNCHES = dict.fromkeys(("ward_serial", "cutree", "rnn_tail", "rnn_round", "rnn_pairs"), 0)
# the problems (serial Ward, cut replay) or lanes (tail, round, pairs) those
# launches took, summed over the launches
PROBLEMS = dict.fromkeys(LAUNCHES, 0)
# the same launches and problems by the mesh position (data, ens) of the
# shard thread that made them (`shard_scope`), kept until cleared
SHARD_LAUNCHES = {}
SHARD_PROBLEMS = {}
_LAUNCHES_LOCK = threading.Lock()
_SHARD = threading.local()


@contextlib.contextmanager
def shard_scope(key):
    """Count the calling thread's launches and problems under `key` in
    SHARD_LAUNCHES and SHARD_PROBLEMS too (`parallel/sharded.py` runs each
    shard's thread under its position)."""
    _SHARD.key = key
    try:
        yield
    finally:
        _SHARD.key = None


def _count(name: str, problems: int) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1
        PROBLEMS[name] += problems
        key = getattr(_SHARD, "key", None)
        if key is not None:
            SHARD_LAUNCHES.setdefault(key, dict.fromkeys(LAUNCHES, 0))[name] += 1
            SHARD_PROBLEMS.setdefault(key, dict.fromkeys(LAUNCHES, 0))[name] += problems


class _ThreadRoutes:
    """The route tensors of the calling thread's last launches (None before
    its first): each shard thread reads its own."""

    def __init__(self):
        self._local = threading.local()

    def __setitem__(self, key, value):
        setattr(self._local, key, value)

    def __getitem__(self, key):
        return getattr(self._local, key, None)


# the route each problem or lane of the last launch took, an int32 tensor on
# the card, kept without a sync: the cut replay's per problem (0 parallel,
# 1 serial) and the tail's per lane (0 the triangle in shared memory, 1 the
# rows in global memory); per thread
ROUTES = _ThreadRoutes()


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device} (cpu or cuda)")
    return x.device.type


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with cudaError_t {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ward_linkage_serial(
    D: torch.Tensor, store_dtype: torch.dtype = torch.float32
) -> LinkageResult:
    """Batched serial Ward.D over float32 D (K, n, n) or (n, n), with the
    matrix stored as `store_dtype` (float32 or bfloat16).

    Same contract and bit-identical output as
    `ops.linkage.ward_linkage(D, "ward.D", store_dtype)` (merges (..., n-1,
    2) int32 with col 0 the survivor, heights float32; D read as symmetric
    from its upper triangle).
    """
    if _device_kind(D) == "cpu":
        return ward_linkage(D, method="ward.D", store_dtype=store_dtype)
    if D.dtype != torch.float32:
        raise TypeError(f"ward_linkage_serial takes float32, got {D.dtype}")
    if store_dtype not in _STORE:
        raise TypeError(f"ward_linkage_serial stores float32 or bfloat16, got {store_dtype}")
    if D.dim() not in (2, 3) or D.shape[-1] != D.shape[-2]:
        raise ValueError(f"ward_linkage_serial takes (K, n, n) or (n, n), got {tuple(D.shape)}")
    if not D.is_contiguous():
        raise ValueError("ward_linkage_serial takes a contiguous D")
    n = D.shape[-1]
    if n < 2:
        raise ValueError(f"ward_linkage_serial takes n >= 2, got {n}")
    from sharp_tpu_torch.ops._build import load_kernels

    lib = load_kernels()["ward_serial.cu"]
    squeeze = D.dim() == 2
    K = 1 if squeeze else D.shape[0]
    D3 = D.reshape(K, n, n)
    W, ldw = None, 0
    if n > WARD_TILE_MAX_N:
        # the working copy the kernel updates in place: symmetric from the
        # upper triangle, rounded to the storage type, rows padded to a
        # multiple of 8 entries for 16-byte loads
        ldw = -(-n // 8) * 8
        W = torch.empty((K, n, ldw), dtype=store_dtype, device=D.device)
        upper = torch.triu(D3, 1)
        W[:, :, :n] = upper + upper.transpose(1, 2)
    # above the shared-memory limit, the row cache's seven words per row
    S = torch.empty((K, 7, n), dtype=torch.int32, device=D.device) if n > WARD_STATE_SMEM_MAX_N else None
    merges = torch.empty((K, n - 1, 2), dtype=torch.int32, device=D.device)
    heights = torch.empty((K, n - 1), dtype=torch.float32, device=D.device)
    rc = lib.sharp_ward_serial_launch(
        D3.data_ptr(), None if W is None else W.data_ptr(), None if S is None else S.data_ptr(),
        merges.data_ptr(), heights.data_ptr(), K, n, ldw, _STORE[store_dtype], _stream(),
    )
    _check_rc(rc, "ward_serial")
    _count("ward_serial", K)
    if squeeze:
        return LinkageResult(merges[0], heights[0])
    return LinkageResult(merges, heights)


def rnn_tail_kernel(
    D: torch.Tensor, alive: torch.Tensor, sizes: torch.Tensor,
    gidx: torch.Tensor, lasth: torch.Tensor,
):
    """Serial-drain the ladder's compacted subproblems D (L, Cn, Cn),
    float32 or bfloat16 storage, alive/sizes/lasth (L, Cn) float32 and
    gidx (L, Cn) int32 -> mi, mj (L, Cn) int32, hh (L, Cn) float32.

    Same contract as `ops.linkage.rnn_tail`; for t < n_alive - 1 the output
    is identical to it. The kernel stops each lane after its n_alive - 1
    merges and leaves zeros in the entries after them. D is only read.

    Up to Cn 256 a lane whose D is exactly symmetric is drained from its
    upper triangle in shared memory; any other lane from its rows in a
    working copy in global memory. `ROUTES["rnn_tail"]` holds the route of
    each lane of the last launch (0 triangle, 1 rows).
    """
    if _device_kind(D) == "cpu":
        return rnn_tail(D, alive, sizes, gidx, lasth)
    if D.dtype not in _STORE:
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
    D = D.contiguous()
    # the working copy of the lanes that take the rows route, filled and
    # updated in place by the kernel; rows padded to a multiple of 8 entries
    # for 16-byte loads
    ldw = -(-Cn // 8) * 8
    W = torch.empty((L, Cn, ldw), dtype=D.dtype, device=D.device)
    state = [x.contiguous() for x in (alive, sizes, gidx, lasth)]
    mi = torch.empty((L, Cn), dtype=torch.int32, device=D.device)
    mj = torch.empty((L, Cn), dtype=torch.int32, device=D.device)
    hh = torch.empty((L, Cn), dtype=torch.float32, device=D.device)
    routes = torch.empty(L, dtype=torch.int32, device=D.device)
    rc = lib.sharp_rnn_tail_launch(
        D.data_ptr(), W.data_ptr(), *(x.data_ptr() for x in state),
        mi.data_ptr(), mj.data_ptr(), hh.data_ptr(), routes.data_ptr(),
        L, Cn, ldw, _STORE[D.dtype], _stream(),
    )
    _check_rc(rc, "rnn_tail")
    _count("rnn_tail", L)
    ROUTES["rnn_tail"] = routes
    return mi, mj, hh


# gridDim.y of the round's kernels holds the lanes
RNN_ROUND_MAX_L = 65535
# the round's state on the card: name, dtype and shape in (L, m, n) terms
_ROUND_STATE = (
    ("alive", torch.bool, ("L", "m")), ("sizes", torch.float32, ("L", "m")),
    ("gidx", torch.int64, ("L", "m")), ("lasth", torch.float32, ("L", "m")),
    ("merges", torch.int32, ("L", "n", 2)), ("heights", torch.float32, ("L", "n")),
    ("cnt", torch.int64, ("L",)), ("rounds", torch.int64, ("L",)),
)


def _round_scratch(ladder, L: int, m: int, P: int):
    """The round's pair buffers, kept on the ladder for the rounds of a
    level: ints (npairs (L), a, b (L, P)), floats (h, na, nb (L, P)), the
    column codes (L, m), the fresh rows (L, P, m) in the storage type and
    the pair-pair entries (L, P, P)."""
    W = ladder.D
    key = (L, m, P, W.dtype, W.device)
    if ladder.scratch is None or ladder.scratch[0] != key:
        dev = W.device
        ladder.scratch = (key, (
            torch.empty(L + 2 * L * P, dtype=torch.int32, device=dev),
            torch.empty(3 * L * P, dtype=torch.float32, device=dev),
            torch.empty((L, m), dtype=torch.int32, device=dev),
            torch.empty((L, P, m), dtype=W.dtype, device=dev),
            torch.empty((L, P, P), dtype=torch.float32, device=dev),
        ))
    return ladder.scratch[1]


def rnn_round_kernel(ladder, nxt: int, P: int) -> None:
    """One round of the reciprocal-NN ladder in place on `ladder` (an
    `ops.linkage.RnnLadder`): the lanes with merges left, more than nxt
    clusters alive and fewer than n rounds at this level merge up to P
    mutual nearest-neighbour pairs each; W (L, m, m), float32 or bfloat16
    storage, its row cache and the cluster and merge state are updated.
    Same contract as `ops.linkage.rnn_round`, and an identical ladder after
    it (`rnn_round` is taken for a CPU tensor).

    Three launches on the current stream, none of which the host waits for
    (csrc/rnn_round.cu): the pairs' selection with the bookkeeping, their
    fresh rows and pair-pair entries, and the scatter with the next row
    cache. A lane with no pair reads and writes nothing of W. Counts one
    launch of "rnn_pairs" (the first two) and one of "rnn_round".
    """
    W = ladder.D
    if _device_kind(W) == "cpu":
        return rnn_round(ladder, nxt, P)
    if W.dtype not in _STORE:
        raise TypeError(f"rnn_round_kernel stores float32 or bfloat16, got {W.dtype}")
    if W.dim() != 3 or W.shape[1] != W.shape[2] or not W.is_contiguous():
        raise ValueError(f"rnn_round_kernel takes a contiguous W (L, m, m), got {tuple(W.shape)}")
    L, m, _ = W.shape
    if not 1 <= L <= RNN_ROUND_MAX_L:
        raise ValueError(f"rnn_round_kernel takes 1 <= L <= {RNN_ROUND_MAX_L}, got {L}")
    if not 1 <= P <= m // 2:
        raise ValueError(f"rnn_round_kernel takes 1 <= P <= m // 2 = {m // 2}, got {P}")
    n = ladder.n
    dims = {"L": L, "m": m, "n": n}
    rowmin, rowarg = ladder.row_cache()
    state = [(name, getattr(ladder, name), dt, shape) for name, dt, shape in _ROUND_STATE]
    state += [("rowmin", rowmin, torch.float32, ("L", "m")), ("rowarg", rowarg, torch.int64, ("L", "m"))]
    for name, x, dt, shape in state:
        shape = tuple(dims.get(d, d) for d in shape)
        if x.dtype != dt or tuple(x.shape) != shape or not x.is_contiguous() or x.device != W.device:
            raise ValueError(
                f"rnn_round_kernel takes {name} {shape} {dt}, contiguous, on {W.device}; got "
                f"{tuple(x.shape)} {x.dtype} on {x.device}"
            )
    from sharp_tpu_torch.ops._build import load_kernels

    lib = load_kernels()["rnn_round.cu"]
    ints, floats, code, F, E = _round_scratch(ladder, L, m, P)
    args = (
        W.data_ptr(), ladder.alive.data_ptr(), ladder.sizes.data_ptr(), ladder.gidx.data_ptr(),
        ladder.lasth.data_ptr(), rowmin.data_ptr(), rowarg.data_ptr(), ladder.merges.data_ptr(),
        ladder.heights.data_ptr(), ladder.cnt.data_ptr(), ladder.rounds.data_ptr(), ints.data_ptr(),
        floats.data_ptr(), code.data_ptr(), F.data_ptr(), E.data_ptr(), L, m, n, nxt, P,
        _STORE[W.dtype], _stream(),
    )
    launch = lib.sharp_rnn_round_launch
    # the bytes are the ladder's count, at each level's end (`ops.linkage._count_level`)
    with kernel("rnn_round"):
        rc = launch(*args)
    _check_rc(rc, "rnn_round")
    _count("rnn_pairs", L)
    _count("rnn_round", L)


def cutree_bytes(G: int, m: int, ncand: int) -> int:
    """The bytes a cut replay of G problems with m merges each must move,
    from shapes: the merges (8 B each) and the real counts read, the
    (G, ncand, m + 1) int32 snapshots written."""
    return G * m * 8 + G * 4 + G * ncand * (m + 1) * 4


def cutree_snapshots_kernel(
    merges: torch.Tensor, n_real, *, minN: int, ncand: int
) -> torch.Tensor:
    """Replay merges (G, n-1, 2) and snapshot labels at every candidate cut
    -> (G, ncand, n) int32. Same contract as `ops.linkage.cutree_snapshots`,
    and identical output, at any n >= 2.

    The kernel takes each problem by its parallel route (deaths, pointer
    jumping and a replay of the last ncand steps) where the merges up to
    the last snapshot are viable, as every linkage of the package emits
    them, and by the serial replay otherwise; `ROUTES["cutree"]` holds the
    route of each problem of the last launch (0 parallel, 1 serial)."""
    if _device_kind(merges) == "cpu":
        add("cutree.bytes", cutree_bytes(*merges.shape[:2], ncand))
        return cutree_snapshots(merges, n_real, minN=minN, ncand=ncand)
    if merges.dtype != torch.int32:
        raise TypeError(f"cutree takes int32 merges, got {merges.dtype}")
    if merges.dim() != 3 or merges.shape[-1] != 2:
        raise ValueError(f"cutree takes merges (G, n-1, 2), got {tuple(merges.shape)}")
    if not merges.is_contiguous():
        raise ValueError("cutree takes contiguous merges")
    G, m, _ = merges.shape
    n = m + 1
    if n < 2:
        raise ValueError(f"cutree takes n >= 2, got {n}")
    if ncand < 1:
        raise ValueError(f"cutree takes ncand >= 1, got {ncand}")
    if merges.data_ptr() % 8:
        merges = merges.clone()   # the kernel reads each (i, j) as one 8-byte word
    nr = counts_per_problem(n_real, G, merges.device)
    from sharp_tpu_torch.ops._build import load_kernels

    lib = load_kernels()["cutree.cu"]
    snaps = torch.empty((G, ncand, n), dtype=torch.int32, device=merges.device)
    routes = torch.empty(G, dtype=torch.int32, device=merges.device)
    scratch = None
    if n > CUTREE_SMEM_MAX_N:
        scratch = torch.empty((G, 2, n), dtype=torch.int32, device=merges.device)
    rc = lib.sharp_cutree_launch(
        merges.data_ptr(), nr.data_ptr(), snaps.data_ptr(),
        routes.data_ptr(), None if scratch is None else scratch.data_ptr(),
        G, n, minN, ncand, _stream(),
    )
    _check_rc(rc, "cutree")
    add("cutree.bytes", cutree_bytes(G, m, ncand))
    _count("cutree", G)
    ROUTES["cutree"] = routes
    return snaps


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
    # the counts go to the card once, for the replay and the validity mask
    nr = counts_per_problem(n_real, mg.shape[0], mg.device)
    snaps = cutree_snapshots_kernel(mg.contiguous(), nr, minN=minN, ncand=ncand)
    out = cut_forest(
        snaps, nr, real_mask, maxN, minN=minN, ncand=ncand, nc_pad=nc_pad
    )
    return CutForest(*(x[0] for x in out)) if squeeze else out
