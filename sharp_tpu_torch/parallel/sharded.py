"""The fold pass of the large tier: the grouped loop on one device, and its
mesh variants over several.

Counterpart of `sharp_tpu/parallel/sharded.py`. Folds are processed `group`
at a time through `core/fold.fold_program`: one group's G*K ensemble
members share one projection, one ladder (its rounds and its tail kernel
are paid once per group, not once per fold) and one cut-replay launch.
Every lane of a group is computed as if alone, so the results do not
depend on the group size, nor on the mesh.

Both feeds stage the next group on a worker thread while the device runs
the current one. A dense block is gathered fold by fold into a small set of
fold-sized host slots, page-locked on a card and reused across calls, and
each slot is copied without blocking into its lane of the group on the
device. A `SparseBlock` ships each group as CSR triplets and is densified
on the device (`io/sparse.py`), with log2(1 + x) applied to the values
there; its groups are sliced into two wire sets, reused across calls, and
copied on a stream of their own by a `SparsePipeline`, which a
`sharp_unlimited` call holds for all its blocks, so that each block's
first group is staged while the previous block's last group runs.

On a mesh (`parallel/mesh.py`) each data shard takes a contiguous slice of
the folds and runs the same grouped loop on its own host thread, under a
stream of its own device: the host launches every operation of the fold
program and reads the ladder's progress once a round, so shards without
threads of their own would run in turn. With an "ens" axis, each ens shard
clusters its contiguous group of members against its column slice of the
RP matrices, and the data shard gathers the members in order and runs
wMetaC once for the group. Unlike the
JAX package's SPMD program, the shards need no dummy folds (threads take
unequal slices) and the sparse feed is not densified on the host.

`indN_cluster` (a fixed cluster count per member) holds for a call of one
dense fold only, as in the JAX package: its grouped and sharded passes
(`sharp_tpu/parallel/sharded.py:31-37`), which a call of two or more folds
and a `SparseBlock` of one fold take (`sharp_tpu/parallel/streaming.py:
70-94`), drop it.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import sys
import threading
import time
import warnings
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from sharp_tpu_torch.config import SharpConfig
from sharp_tpu_torch.core.block import BlockEnsembleResult, cluster_block_ensemble
from sharp_tpu_torch.core.fold import fold_program, fold_static_args, fold_summary
from sharp_tpu_torch.core.large import summaries_to_host
from sharp_tpu_torch.ops.linkage import counts_per_problem
from sharp_tpu_torch.ops.linkage_cuda import shard_scope
from sharp_tpu_torch.ops.silhouette import SWEEP_CHUNK_BYTES, sweep_bytes
from sharp_tpu_torch.utils.timers import add, log, span, tracing

_CPU_BUDGET = 8 << 30


def memory_budget_bytes(devices="cuda") -> int:
    """Memory for one group's working set: `SHARP_TPU_HBM_BUDGET` (bytes)
    when it is set, as in the JAX package; else 80% of a card's free memory
    (`torch.cuda.mem_get_info`) divided among the shards on that card and
    the processes that share it (`multihost.processes_per_card`), the least
    over the cards; 8 GiB on the CPU. `devices`: one device, or the shards'
    devices (a card listed twice holds two working sets)."""
    env = os.environ.get("SHARP_TPU_HBM_BUDGET")
    if env:
        return int(env)
    devs = [torch.device(d) for d in (devices if isinstance(devices, (list, tuple)) else [devices])]
    cards = [torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
             for d in devs if d.type == "cuda"]
    if not cards:
        return _CPU_BUDGET
    from sharp_tpu_torch.parallel.multihost import processes_per_card

    procs = processes_per_card()
    return min(int(0.8 * torch.cuda.mem_get_info(c)[0]) // (cards.count(c) * procs) for c in set(cards))


# the JAX package's name
hbm_budget_bytes = memory_budget_bytes


def _fold_bytes(block_pad: int, genes: int, sparse: bool, K: int, ncand: int, nc_pad: int) -> int:
    """The working set one fold adds to a group (`auto_group`'s model)."""
    dense_copies = 2 if sparse else 3
    return (dense_copies * block_pad * genes * 4 + 5 * K * block_pad * block_pad * 4
            + sweep_bytes(K, block_pad, ncand, nc_pad))


def auto_group(
    block_pad: int, genes: int, sparse: bool = False, cap: int = 16,
    *, K: int, device, ncand: int = 39, nc_pad: int = 48,
) -> int:
    """Fold-group size that fits the memory budget, at most `cap`.

    Per fold, a group holds K lanes of the linkage working set (the
    distance matrix, its masked copy for the silhouettes and up to three
    matrices inside a ladder round: 5 x K x block_pad^2 float32), K lanes
    of the candidate sweep's tables (`ops.silhouette.sweep_bytes`, with
    ncand candidates and nc_pad cluster slots), and the dense fold: with
    the dense feed, the fold and its log2 copy on the device plus its lane
    of the next group, which the feed fills meanwhile (3 x block_pad x
    genes float32); with the sparse feed,
    the fold densified on the device with log2 applied and the scatter's
    working set (2 x block_pad x genes float32). The sweep's chunked
    scoring (`SWEEP_CHUNK_BYTES`) is held once per group. `device` as in
    `memory_budget_bytes`; K the members one device holds.
    """
    fold_bytes = _fold_bytes(block_pad, genes, sparse, K, ncand, nc_pad)
    fit = (memory_budget_bytes(device) - SWEEP_CHUNK_BYTES) // fold_bytes
    for g in (16, 8, 4, 2):
        if fit >= g and cap >= g:
            return g
    return 1


def _sweep_shape(cfg: SharpConfig) -> dict:
    static = fold_static_args(cfg)
    return dict(ncand=static["ncand"], nc_pad=static["nc_pad"])


# the parts of the fold pass that SHARP_TPU_FOLD_TIMING=1 adds up
FOLD_TIMING_KEYS = ("slice_s", "transfer_s", "device_s", "readback_s")
# the dense feed's host seconds, added up on every call with no synchronise
FEED_KEYS = ("slice_s", "transfer_s")
# the sparse feed's: the caller's waits for a staged group besides
SPARSE_FEED_KEYS = FEED_KEYS + ("wait_s",)


def _now(timing: Optional[dict]) -> float:
    """The host clock where the pass is timed, else 0 without reading it."""
    return time.perf_counter() if timing is not None else 0.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# the dense feed's host slots: at most this many, and at most this many
# bytes of them
_MAX_SLOTS = 4
_SLOT_BYTES = 1 << 30


class _Slots:
    """Fold-sized (block_pad, genes) float32 host buffers for copies to dev.
    On a card: page-locked, with the CUDA event after the last copy out of
    each and the stream the copies run on, kept with the slots so that the
    caching allocator reuses the group buffers it allocated on it."""

    def __init__(self, block_pad: int, genes: int, dev: torch.device):
        n = max(2, min(_MAX_SLOTS, _SLOT_BYTES // (block_pad * genes * 4)))
        self.pinned = dev.type == "cuda"
        self.bufs = [torch.empty((block_pad, genes), dtype=torch.float32, pin_memory=self.pinned)
                     for _ in range(n)]
        self.copied: list = [None] * n
        self.stream = torch.cuda.Stream(device=dev) if self.pinned else None


# (block_pad, genes, device) -> the slot sets no feed holds, kept for the next
_FREE_SLOTS: dict = {}
_FREE_LOCK = threading.Lock()


@contextlib.contextmanager
def _staging(block_pad: int, genes: int, dev: torch.device):
    """A slot set for one feed, reused across calls: taken from the free
    sets of its shape and device (made where there is none) and given back
    after. Free sets of another shape on the device are dropped."""
    key = (block_pad, genes, dev)
    with _FREE_LOCK:
        for k in [k for k in _FREE_SLOTS if k[2] == dev and k != key]:
            del _FREE_SLOTS[k]
        free = _FREE_SLOTS.get(key)
        slots = free.pop() if free else None
    if slots is None:
        slots = _Slots(block_pad, genes, dev)
    try:
        yield slots
    finally:
        with _FREE_LOCK:
            _FREE_SLOTS.setdefault(key, []).append(slots)


def _group_buffer(n: int, block_pad: int, genes: int, dev: torch.device) -> torch.Tensor:
    """The n folds of a group on dev, which the dense feed fills lane by lane."""
    return torch.empty((n, block_pad, genes), dtype=torch.float32, device=dev)


def _dense_feed(X, sizes, offsets, group, block_pad, rows, logf, dev, timing, feed=None):
    """Per group: (fold sizes, dense folds on dev, log2 still to apply).

    A worker thread stages group g + 1 while the caller runs group g: it
    gathers fold t (`X[rows[offsets[t] : offsets[t] + sizes[t]]]`, pad rows
    zero) into slot t % S of a `_Slots` set and copies the slot without
    blocking into its lane of a fresh group buffer on dev. On a card the
    slots are page-locked, the copies run on a stream of their own, a slot
    is refilled only after the copy out of it has finished, and the caller's
    stream, not the host, waits for the group's last copy; at most two
    group buffers are alive, the one computed and the one filled. With
    `timing` the parts run in turn and the copies are synchronised.

    `feed` (a dict of `FEED_KEYS`) adds up the worker's host seconds in the
    gathers and in the copies' calls, read without a synchronise; the span
    `fold_pass.wait` holds the caller's wait for a group. While tracing,
    the tracer sums the bytes of the live rows gathered
    (`feed.gathered_bytes`), the bytes copied to dev, pad rows included
    (`feed.copied_bytes`), and of those the ones copied from page-locked
    slots (`feed.pinned_bytes`) and from pageable ones
    (`feed.pageable_bytes`)."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cuda = dev.type == "cuda"
    genes = X.shape[1]
    with warnings.catch_warnings():   # a read-only X is only read
        warnings.simplefilter("ignore", UserWarning)
        src = torch.from_numpy(np.ascontiguousarray(X, np.float32))
    idx = torch.from_numpy(np.ascontiguousarray(rows, np.int64))
    n_groups = -(-len(sizes) // group)

    def stage(gi, slots):
        g0 = gi * group
        gsizes = [int(s) for s in sizes[g0 : g0 + group]]
        slice_s = transfer_s = 0.0
        with _on(dev, slots.stream):
            data = _group_buffer(len(gsizes), block_pad, genes, dev)
            for j, sz in enumerate(gsizes):
                s = (g0 + j) % len(slots.bufs)
                slot = slots.bufs[s]
                if slots.copied[s] is not None:
                    slots.copied[s].synchronize()
                t0 = time.perf_counter()
                with span("fold_pass.slice"):
                    r0 = int(offsets[g0 + j])
                    torch.index_select(src, 0, idx[r0 : r0 + sz], out=slot[:sz])
                    slot[sz:].zero_()
                t1 = time.perf_counter()
                with span("fold_pass.transfer"):
                    data[j].copy_(slot, non_blocking=True)
                    if cuda:
                        slots.copied[s] = torch.cuda.Event()
                        slots.copied[s].record()
                slice_s += t1 - t0
                transfer_s += time.perf_counter() - t1
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record()
                if timing is not None:
                    t1 = time.perf_counter()
                    slots.stream.synchronize()
                    transfer_s += time.perf_counter() - t1
        return gsizes, data, ready, slice_s, transfer_s

    with _staging(block_pad, genes, dev) as slots, concurrent.futures.ThreadPoolExecutor(1) as pool:
        staged = pool.submit(stage, 0, slots)
        for gi in range(n_groups):
            with span("fold_pass.wait"):
                gsizes, data, ready, slice_s, transfer_s = staged.result()
            # timed, the next group is staged after this one's device part
            staged = pool.submit(stage, gi + 1, slots) if gi + 1 < n_groups and timing is None else None
            if cuda:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(ready)
                data.record_stream(stream)   # not handed out again before the caller's work on it
            for sums in (feed, timing):
                if sums is not None:
                    sums["slice_s"] += slice_s
                    sums["transfer_s"] += transfer_s
            if tracing():
                add("feed.gathered_bytes", sum(gsizes) * genes * 4)
                add("feed.copied_bytes", data.nbytes)
                add("feed.pinned_bytes", data.nbytes if slots.pinned else 0)
                add("feed.pageable_bytes", 0 if slots.pinned else data.nbytes)
            yield gsizes, data, logf
            del data   # this frame's reference: the group goes when the caller drops its own
            if staged is None and gi + 1 < n_groups:
                staged = pool.submit(stage, gi + 1, slots)


# device -> the (wire sets, copy stream) no sparse pipeline holds, kept for
# the next: the caching allocator reuses the device wires it allocated on
# the stream
_FREE_WIRE: dict = {}
_FREE_WIRE_LOCK = threading.Lock()


class _WireSet:
    """Host bytes for one fold group's wire (counts, cols, vals), page-locked
    on a card and grown only where a group needs more, and the CUDA event
    after the last copy out of them."""

    def __init__(self):
        self.bufs = [torch.empty(0, dtype=torch.uint8)] * 3
        self.copied = None

    def views(self, G: int, group: int, wire, pin: bool):
        """(G, width) views of the given (width, dtype)s, each contiguous
        at the start of its buffer, and whether a buffer had to be made:
        one that holds `group` rows, so a block's short last group fits."""
        made, out = False, []
        for j, (width, dtype) in enumerate(wire):
            if self.bufs[j].numel() < group * width * dtype.itemsize:
                self.bufs[j] = torch.empty(group * width * dtype.itemsize, dtype=torch.uint8, pin_memory=pin)
                made = True
            out.append(self.bufs[j][: G * width * dtype.itemsize].view(dtype).view(G, width))
        return out, made


class _Block(NamedTuple):
    """A SparseBlock's fold groups as the sparse feed stages them."""

    sb: object
    sizes: tuple
    offsets: np.ndarray
    group: int
    block_pad: int
    budget: int     # nonzeros a fold's wire holds: the block's largest fold, padded

    @classmethod
    def of(cls, sb, sizes, offsets, group, block_pad):
        from sharp_tpu_torch.io.sparse import nnz_pad

        sizes = tuple(int(s) for s in sizes)
        budget = nnz_pad(max(int(sb.indptr[offsets[t] + sizes[t]] - sb.indptr[offsets[t]])
                             for t in range(len(sizes))))
        return cls(sb, sizes, offsets, group, block_pad, budget)

    def same(self, other: "_Block") -> bool:
        return (self.sb is other.sb and self.sizes == other.sizes and self.group == other.group
                and self.block_pad == other.block_pad and self.budget == other.budget)


class _Staged(NamedTuple):
    gsizes: list
    host: list      # the wire in a set's views
    data: list      # the wire on the device (the views themselves on the CPU)
    ready: object   # the CUDA event after its copies, or None
    slice_s: float
    transfer_s: float


class SparsePipeline:
    """The sparse feed's staging, one for a `sharp_unlimited` call (or, where
    no caller holds one, for one block's fold pass): a worker thread, and
    two wire sets with a copy stream (on a card), taken from the free ones
    of the device and given back after.

    The worker stages the fold groups in order: it slices a group's wire
    into the next set, once the copy out of it has finished, and issues the
    set's copy to the device without blocking on the copy stream, with an
    event the caller's stream waits on. `upcoming`, which the caller sets
    per block, returns what `sparse_plan` gives for the block that runs
    next (it may wait for that block's load); when the caller takes a
    block's last group, the worker goes on to that block's first group, so
    that it is sliced and copied beside the last group's fold program and
    the caller's work between the blocks. Groups never straddle blocks."""

    def __init__(self, dev, wire_dtype: str = "float32"):
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.dev, self.wire_dtype, self.cuda = dev, wire_dtype, dev.type == "cuda"
        with _FREE_WIRE_LOCK:
            free = _FREE_WIRE.get(dev)
            self.sets, self.stream = free.pop() if free else (None, None)
        if self.sets is None:
            self.sets = [_WireSet(), _WireSet()]
            self.stream = torch.cuda.Stream(device=dev) if self.cuda else None
        self.turn = 0           # the set the worker fills next, alternating
        self.pool = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="sparse-feed")
        self.upcoming: Optional[Callable] = None
        self.ahead = None       # the future of the next block's first group, staged ahead

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self) -> None:
        """Let the worker finish and give the sets back; a group staged and
        never taken is dropped (its set is refilled after its copy's event)."""
        self.ahead = self.upcoming = None
        self.pool.shutdown(wait=True)
        with _FREE_WIRE_LOCK:
            _FREE_WIRE.setdefault(self.dev, []).append((self.sets, self.stream))

    def submit(self, blk: _Block, gi: int, timing: Optional[dict]):
        return self.pool.submit(self._stage, blk, gi, timing)

    def look_ahead(self) -> None:
        """The next job: the first group of the block `upcoming` names."""
        upcoming, self.upcoming = self.upcoming, None
        if upcoming is not None:
            self.ahead = self.pool.submit(self._stage_upcoming, upcoming)

    def take_ahead(self, blk: _Block) -> Optional[_Staged]:
        """blk's first group where it was staged ahead, else None (waits for
        a group staged ahead; one staged for another block is dropped)."""
        ahead, self.ahead = self.ahead, None
        got = ahead.result() if ahead is not None else None
        if got is None or not got[0].same(blk):
            return None
        add("feed.block_first_ahead", 1)
        return got[1]

    def _stage_upcoming(self, upcoming):
        try:
            plan = upcoming()
        except Exception:   # the block's load failed: the caller raises it when it reads the block itself
            return None
        if plan is None:
            return None
        sb, sizes, block_pad, group = plan
        blk = _Block.of(sb, sizes, np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64), group, block_pad)
        return blk, self._stage(blk, 0, None)

    def _stage(self, blk: _Block, gi: int, timing: Optional[dict]) -> _Staged:
        from sharp_tpu_torch.io.sparse import fold_triplets, wire_dtypes

        g0 = gi * blk.group
        gsizes = list(blk.sizes[g0 : g0 + blk.group])
        G, sb = len(gsizes), blk.sb
        ws = self.sets[self.turn % 2]
        self.turn += 1
        if ws.copied is not None:
            ws.copied.synchronize()
        t0 = time.perf_counter()
        with span("fold_pass.slice"):
            cdt, vdt = wire_dtypes(sb.g, self.wire_dtype)
            views, made = ws.views(G, blk.group, ((blk.block_pad, torch.int32), (blk.budget, cdt), (blk.budget, vdt)),
                                   self.cuda)
            if made:
                add("feed.wire_sets_made", 1)
            starts = [int(blk.offsets[g0 + j]) for j in range(G)]
            host = fold_triplets(sb, starts, gsizes, blk.block_pad, blk.budget, self.wire_dtype, out=views)
        t1 = time.perf_counter()
        ready = None
        with span("fold_pass.transfer"), _on(self.dev, self.stream):
            data = [t.to(self.dev, non_blocking=True) for t in host]
            if self.cuda:
                ready = ws.copied = torch.cuda.Event()
                ready.record()
                if timing is not None:
                    self.stream.synchronize()
        return _Staged(gsizes, host, data, ready, t1 - t0, time.perf_counter() - t1)


def sparse_plan(X, sizes, block_pad: int, cfg: SharpConfig, device, mesh=None, group: Optional[int] = None):
    """What the grouped pass of `process_folds` stages for X: (X, its fold
    sizes, block_pad, the group size `process_folds_grouped` takes), or
    None where X is dense or its folds go over the mesh."""
    from sharp_tpu_torch.io.sparse import SparseBlock

    if not isinstance(X, SparseBlock) or (mesh is not None and len(sizes) > 1):
        return None
    if group is None:
        group = auto_group(block_pad, X.g, True, K=cfg.ensize_K, device=torch.device(device), **_sweep_shape(cfg))
    return X, list(sizes), block_pad, max(1, min(group, len(sizes)))


def _sparse_feed(sb, sizes, offsets, group, block_pad, logf, pipe: SparsePipeline, timing, feed=None):
    """Per group: (fold sizes, folds densified on dev with log2 applied,
    False), staged by `pipe` (`SparsePipeline`): group g + 1 is sliced and
    copied on its worker while the caller runs group g, and when the caller
    takes the last group the worker goes on to the next block's first. The
    caller's stream waits for a group's copies and densifies it. Each
    group's wire is a contiguous (G, budget) view of a set, budget the
    block's largest fold's nonzeros padded (`nnz_pad`). With `timing` the
    groups are staged in turn, none ahead, the card synchronised after each
    part, the densify counted as device time.

    `feed` (a dict) adds up `SPARSE_FEED_KEYS`, host seconds read with no
    synchronise: the worker's slicing, its copies' calls and the caller's
    waits for a staged group (the span `fold_pass.wait`, the feed's exposed
    part). While tracing, the tracer sums the nonzeros of the groups
    (`feed.nnz`), the bytes of the triplet buffers copied to dev
    (`feed.wire_bytes`), of those the ones copied from page-locked memory
    (`feed.wire_pinned_bytes`), the bytes of the dense folds written on dev
    (`feed.dense_bytes`), the blocks whose first group was staged ahead
    (`feed.block_first_ahead`) and the wire sets made
    (`feed.wire_sets_made`)."""
    from sharp_tpu_torch.io.sparse import densify_folds

    blk = _Block.of(sb, sizes, offsets, group, block_pad)
    n_groups = -(-len(sizes) // group)
    staged = None
    for gi in range(n_groups):
        last = gi + 1 == n_groups
        t0 = time.perf_counter()
        with span("fold_pass.wait"):
            rec = staged.result() if gi else pipe.take_ahead(blk)
            if rec is None:
                rec = pipe.submit(blk, 0, timing).result()
        t1 = time.perf_counter()
        if timing is None:   # timed, the next group is staged after this one's device part
            if last:
                pipe.look_ahead()
            else:
                staged = pipe.submit(blk, gi + 1, None)
        if pipe.cuda:
            stream = torch.cuda.current_stream(pipe.dev)
            stream.wait_event(rec.ready)
            for t in rec.data:
                t.record_stream(stream)   # not handed out again before the caller's work on it
        for sums in (feed, timing):
            if sums is not None:
                sums["slice_s"] = sums.get("slice_s", 0.0) + rec.slice_s
                sums["transfer_s"] = sums.get("transfer_s", 0.0) + rec.transfer_s
        if feed is not None:
            feed["wait_s"] = feed.get("wait_s", 0.0) + t1 - t0
        t2 = _now(timing)
        with span("fold_pass.device"):
            Xg = densify_folds(*rec.data, block_pad=block_pad, genes=sb.g, log2p1=logf)
            if timing is not None:
                _sync(pipe.dev)
                timing["device_s"] += _now(timing) - t2
        if tracing():
            g0 = gi * group
            wire = sum(t.nbytes for t in rec.host)
            add("feed.nnz", int(sb.indptr[offsets[g0 + len(rec.gsizes)]] - sb.indptr[offsets[g0]]))
            add("feed.wire_bytes", wire)
            add("feed.wire_pinned_bytes", wire if pipe.cuda and all(t.is_pinned() for t in rec.host) else 0)
            add("feed.dense_bytes", Xg.nbytes)
        gsizes = rec.gsizes
        del rec   # the device wire goes once the densify is done with it
        yield gsizes, Xg, False
        if timing is not None and not last:
            staged = pipe.submit(blk, gi + 1, timing)


def _fold_groups(
    X, sizes, offsets, block_pad, R_all, cfg, logf, dev, group, rows, wire_dtype, indN,
    ens: Optional[Callable] = None, timing: Optional[dict] = None, feed: Optional[dict] = None,
    pipeline: Optional[SparsePipeline] = None,
) -> List[dict]:
    """The summaries of the folds `sizes` (fold t starting at cell
    offsets[t] of X, or of `rows`), `group` folds per call on dev. `ens`
    replaces the fold program of a group by the ensemble split. `timing`
    (a dict of `FOLD_TIMING_KEYS`) adds up the parts of the pass, the card
    synchronised after each; `feed` (a dict of `FEED_KEYS`) the feed's
    host seconds, with no synchronise (the sparse feed's
    `SPARSE_FEED_KEYS`). A SparseBlock's groups are staged by `pipeline`,
    the caller's `SparsePipeline`, else by one made for this pass."""
    from sharp_tpu_torch.io.sparse import SparseBlock

    with contextlib.ExitStack() as stack:
        if isinstance(X, SparseBlock):
            pipe = pipeline or stack.enter_context(SparsePipeline(dev, wire_dtype))
            groups = _sparse_feed(X, sizes, offsets, group, block_pad, logf, pipe, timing, feed)
        else:
            groups = _dense_feed(X, sizes, offsets, group, block_pad, rows, logf, dev, timing, feed)
        static = fold_static_args(cfg)
        results: List[dict] = []
        for gsizes, Xg, eff_logf in groups:
            t0 = _now(timing)
            with span("fold_pass.device"):
                masks = (torch.arange(block_pad)[None, :] < torch.tensor(gsizes)[:, None]).to(dev)
                if ens is None:
                    out = fold_program(Xg, masks, gsizes, R_all, eff_logf, indN, has_indN=indN is not None, **static)
                else:
                    out = ens(Xg, masks, gsizes, eff_logf, indN)
                del Xg
                if timing is not None:
                    _sync(dev)
                    t1 = _now(timing)
                    timing["device_s"] += t1 - t0
            with span("fold_pass.readback"):
                results.extend(summaries_to_host(out, gsizes, cfg.forview))
            if timing is not None:
                timing["readback_s"] += _now(timing) - t1
        return results


def _report_fold_timing(timing: dict) -> None:
    """The JAX package's `[fold-timing]` line, to stderr and the log."""
    parts = " ".join(f"{k}={v:.2f}" for k, v in timing.items())
    log("fold pass timing: " + parts)
    print("[fold-timing] " + parts, file=sys.stderr, flush=True)


def _check_feed(X, rows):
    from sharp_tpu_torch.io.sparse import SparseBlock

    sparse = isinstance(X, SparseBlock)
    if sparse and rows is not None:
        raise ValueError("a SparseBlock is processed in its own cell order (rows=None)")
    return sparse, None if sparse else (np.arange(X.shape[0]) if rows is None else np.asarray(rows))


def process_folds_grouped(
    X,                           # (n, genes) cells, or a SparseBlock
    sizes: Sequence[int],        # fold sizes
    block_pad: int,
    R_all: torch.Tensor,         # (genes, K*p) on the device
    cfg: SharpConfig,
    logf: bool,
    group: Optional[int] = None,
    wire_dtype: str = "float32",
    *,
    device="cuda",
    rows: Optional[np.ndarray] = None,
    feed: Optional[dict] = None,
    pipeline: Optional[SparsePipeline] = None,
) -> List[dict]:
    """Run the fold program over all folds, `group` folds per call, and
    return per-fold host summaries.

    Fold t holds the cells rows[offsets[t] : offsets[t] + sizes[t]] of X
    (`rows`: the cell order, default X's own; a SparseBlock keeps its own
    order). `group=None` sizes the group from the memory budget
    (`auto_group`). `wire_dtype` is the sparse feed's value type. With
    `SHARP_TPU_FOLD_TIMING=1` the pass synchronises the card after each
    part and prints the seconds of each (`[fold-timing] slice_s=...
    transfer_s=... device_s=... readback_s=...`, to stderr): the host's
    slicing, the copies to the card, the densify and the fold program, and
    the summaries' readback. Without it a profiler sees the same four parts
    as the spans `sharp.fold_pass.{slice,transfer,device,readback}`, on its
    own clock and with no synchronise. `feed`, a dict of `FEED_KEYS`, adds
    up the feed's host seconds on every call, with no synchronise (a
    SparseBlock's feed adds `SPARSE_FEED_KEYS`). `pipeline`, a
    `SparsePipeline` on `device`, stages a SparseBlock's groups (a call of
    `sharp_unlimited` holds one for all its blocks); without it the pass
    makes its own.
    """
    dev = torch.device(device)
    T = len(sizes)
    sparse, rows = _check_feed(X, rows)
    if group is None:
        group = auto_group(block_pad, X.shape[1], sparse, K=cfg.ensize_K, device=dev, **_sweep_shape(cfg))
        log(f"fold group auto-sized to {group}")
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    # the JAX package keeps indN_cluster only where one dense fold takes
    # its one-fold program (`process_fold`); its sparse feed and its passes
    # of several folds drop it
    indN = cfg.indN_cluster if T == 1 and not sparse else None
    timing = (dict.fromkeys(FOLD_TIMING_KEYS, 0.0)
              if os.environ.get("SHARP_TPU_FOLD_TIMING") == "1" else None)
    results = _fold_groups(X, list(sizes), offsets, block_pad, R_all, cfg, logf, dev,
                           max(1, min(group, T)), rows, wire_dtype, indN, timing=timing, feed=feed,
                           pipeline=pipeline)
    if timing is not None:
        _report_fold_timing(timing)
    return results


@contextlib.contextmanager
def _on(dev: torch.device, stream):
    """Run on dev: on a card, make it the thread's device and `stream` its
    current stream."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


def _ens_program(d, devs, streams, R_locals, pool, static, K_local):
    """The fold program of a group with the K members split over the ens
    shards devs[e] (members [e*K_local, (e+1)*K_local), against their
    columns R_locals[e] of the RP matrices), each on its own thread and
    stream; the members gathered in order onto devs[0], where wMetaC runs.
    The ensemble-mean projection is the mean of the shards' means, as the
    JAX package's `pmean` over "ens" computes it. `d` is the data shard,
    for the launch counts."""
    blk_keys = ("minN", "ncand", "nc_pad", "sil_thre", "height_Ntimes", "linkage_backend", "hmethod")
    blk_static = {k: static[k] for k in blk_keys}
    sum_static = {k: v for k, v in static.items() if k != "sil_thre"}
    home = devs[0]

    def run(Xg, masks, gsizes, logf, indN):
        home_stream = torch.cuda.current_stream(home) if home.type == "cuda" else None
        nreal = counts_per_problem(gsizes, len(gsizes), home)   # once, for every shard

        def shard(e):
            dev = devs[e]
            with _on(dev, streams[e]), shard_scope((d, e)):
                if home_stream is not None and dev.type == "cuda":
                    torch.cuda.current_stream().wait_stream(home_stream)
                blk = cluster_block_ensemble(
                    Xg.to(dev), masks.to(dev), nreal.to(dev), R_locals[e], static["maxN"], logf,
                    K=K_local, indN_cluster=indN, **blk_static,
                )
                if dev.type == "cuda":
                    torch.cuda.current_stream().synchronize()
                    for t in blk:
                        if t.device == home:
                            t.record_stream(home_stream)
                return blk

        parts = list(pool.map(shard, range(len(devs))))
        blk = BlockEnsembleResult(
            labels=torch.cat([b.labels.to(home) for b in parts], dim=2),
            k_per=torch.cat([b.k_per.to(home) for b in parts], dim=1),
            maxsil=torch.cat([b.maxsil.to(home) for b in parts], dim=1),
            mean_proj=torch.stack([b.mean_proj.to(home) for b in parts]).mean(dim=0),
        )
        return fold_summary(blk, masks, nreal, **sum_static)

    return run


def process_folds_sharded(
    X,                           # (n, genes) cells, or a SparseBlock
    sizes: Sequence[int],        # fold sizes
    block_pad: int,
    R_all: torch.Tensor,         # (genes, K*p), member-major
    cfg: SharpConfig,
    logf: bool,
    mesh,
    rows: Optional[np.ndarray] = None,
    wire_dtype: str = "float32",
    group: Optional[int] = None,
    *,
    feed: Optional[dict] = None,
) -> List[dict]:
    """The fold pass over `mesh` (`parallel/mesh.Mesh`): per-fold host
    summaries in fold order, the same as `process_folds_grouped`'s.

    Data shard d runs folds `block_slice(T, d, n_data)` (a contiguous slice)
    through the grouped loop on mesh.devices[d][0], with the dense feed over
    `rows` or the sparse feed; with an "ens" axis its members are split
    over mesh.devices[d]. R_all is copied to each device once (its column
    slice, with an "ens" axis). `group=None` sizes each shard's group from
    its share of the memory budget. Like the JAX package's, this pass drops
    `indN_cluster`; `process_folds` sends a call of one fold to the grouped
    loop, which keeps it. `feed` adds up the shards' dense feed seconds.
    """
    from sharp_tpu_torch.parallel.multihost import block_slice

    T = len(sizes)
    n_data, n_ens = mesh.shape["data"], mesh.shape["ens"]
    K = cfg.ensize_K
    if K % n_ens:
        raise ValueError(f"ensize_K={K} must divide over ens={n_ens}")
    K_local = K // n_ens
    p = R_all.shape[1] // K
    sparse, rows = _check_feed(X, rows)
    flat = mesh.flat()
    if any(d.type == "cuda" for d in flat):
        from sharp_tpu_torch.ops._build import load_kernels

        load_kernels()   # built once, before the shard threads start
    if group is None:
        group = auto_group(block_pad, X.shape[1], sparse, K=K_local, device=flat, **_sweep_shape(cfg))
        log(f"fold group auto-sized to {group} per shard")
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    static = fold_static_args(cfg)

    copies = {}   # each column slice once per device

    def R_on(dev, e):
        # member-major columns: ens shard e's members are one contiguous slice
        lo, hi = e * K_local * p, (e + 1) * K_local * p
        if (dev, lo) not in copies:
            copies[dev, lo] = R_all[:, lo:hi].contiguous().to(dev)
        return copies[dev, lo]

    streams = [
        [torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in row] for row in mesh.devices
    ]
    R_locals = [[R_on(d, e) for e, d in enumerate(row)] for row in mesh.devices]
    for d in set(flat):   # the copies finish before the shards' streams read them
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()

    shard_feeds = [dict.fromkeys(FEED_KEYS, 0.0) for _ in range(n_data)]

    def data_shard(d):
        folds = block_slice(T, d, n_data)
        if not folds:
            return []
        lo, hi = folds[0], folds[-1] + 1
        devs = mesh.devices[d]
        with contextlib.ExitStack() as stack:
            ens = None
            if n_ens > 1:
                pool = stack.enter_context(concurrent.futures.ThreadPoolExecutor(n_ens))
                ens = _ens_program(d, devs, streams[d], R_locals[d], pool, static, K_local)
            stack.enter_context(_on(devs[0], streams[d][0]))
            stack.enter_context(shard_scope((d, 0)))
            out = _fold_groups(
                X, list(sizes[lo:hi]), offsets[lo:hi + 1], block_pad, R_locals[d][0], cfg, logf,
                devs[0], max(1, min(group, hi - lo)), rows, wire_dtype, None, ens=ens, feed=shard_feeds[d],
            )
            if devs[0].type == "cuda":
                torch.cuda.current_stream().synchronize()
            return out

    with concurrent.futures.ThreadPoolExecutor(n_data) as pool:
        parts = list(pool.map(data_shard, range(n_data)))
    if feed is not None:
        for k in set().union(*shard_feeds):
            feed[k] = feed.get(k, 0.0) + sum(f.get(k, 0.0) for f in shard_feeds)
    log(f"sharded fold pass: {T} folds over {n_data} data shards"
        + (f" x {n_ens} ens shards" if n_ens > 1 else ""))
    return [fr for part in parts for fr in part]


def process_folds(
    X, sizes: Sequence[int], block_pad: int, R_all: torch.Tensor, cfg: SharpConfig, logf: bool, device,
    mesh=None, rows: Optional[np.ndarray] = None, group: Optional[int] = None, wire_dtype: str = "float32",
    *, feed: Optional[dict] = None, pipeline: Optional[SparsePipeline] = None,
) -> List[dict]:
    """The fold pass of the large tier and of each streamed block: over
    `mesh` for two or more folds (`process_folds_sharded`), else the grouped
    loop on `device` (`process_folds_grouped`), as the JAX package's
    `sharp_large` and `_fold_pass` choose (`sparse_plan` follows the same
    choice). `feed`, a dict of `FEED_KEYS`, adds up the feed's host seconds
    (a SparseBlock's feed adds `SPARSE_FEED_KEYS`); `pipeline` stages a
    SparseBlock's groups on the grouped loop."""
    if mesh is not None and len(sizes) > 1:
        return process_folds_sharded(X, sizes, block_pad, R_all, cfg, logf, mesh, rows=rows,
                                     wire_dtype=wire_dtype, group=group, feed=feed)
    return process_folds_grouped(X, sizes, block_pad, R_all, cfg, logf, group, wire_dtype, device=device,
                                 rows=rows, feed=feed, pipeline=pipeline)
