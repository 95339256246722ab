"""Structured per-stage timing, logging, and the port's tracer.

The reference brackets every entry point with `Sys.time()` and narrates stages
with `cat()` (R/SHARP.R:48,282-290). The port keeps the same observable
milestones as structured records, so results carry their timing breakdown.
Stage times are host wall clock: a stage that ends in a device readback
(every stage of the small path does) includes the device work.

The tracer records while a `torch.profiler` (or `torch.autograd.profiler`)
session records, and only then; off, each of its sites costs one attribute
read. It keeps no clock of its own:

* `span(name)` opens `record_function("sharp.<name>")`, so the program's
  layers sit in the profiler's trace on the clock of the device activity,
  and an idle gap of the device is named after the innermost span; `sub`
  names a span after the innermost open one, for code that several layers
  share. The tracer counts each span's calls.
* `host_read(x, site)` is every read of a device value by the host on the
  main paths, counted by site (its layer first) and under each open span.
* `kernel(name)` puts a CUDA event pair around a hand-written kernel's
  launch call on its stream.
* `add`/`add_device` keep sums (on the host, or on the device with no read);
  a sum keyed `<kernel>.bytes` is the bytes that kernel's launches must move.

`snapshot()` reads it all (the events and device sums only there), and
`reset()` clears it.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from collections import Counter
from typing import Dict, List

import torch
import torch.autograd.profiler as _profiler


_VERBOSE = os.environ.get("SHARP_TPU_VERBOSE", "0") not in ("0", "", "false")


def log(msg: str) -> None:
    if _VERBOSE:
        print(f"[sharp_tpu_torch] {msg}", file=sys.stderr, flush=True)


# --- the tracer -------------------------------------------------------------

PREFIX = "sharp."
_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()
_LOCAL = threading.local()          # .stack: the names of the thread's open spans
_SPANS: Counter = Counter()         # calls of each span
_READS: Counter = Counter()         # host reads by site
_READS_UNDER: Counter = Counter()   # host reads made while each span was open
_SUMS: Counter = Counter()          # host sums by key
_DEVICE_SUMS: Dict[tuple, torch.Tensor] = {}   # (key, device) -> a 0-d accumulator
BYTES = ".bytes"                    # a sum keyed "<kernel>.bytes" is the kernel's bytes
_EVENTS: Dict[str, List[tuple]] = {}   # kernel -> [(start, end) CUDA events] not yet read
_KERNEL_MS: Counter = Counter()     # kernel -> milliseconds of events already read


def tracing() -> bool:
    """Whether a profiler records, which is when the tracer does."""
    return _profiler._is_profiler_enabled


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class _Span:
    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = _profiler.record_function(PREFIX + name)

    def __enter__(self):
        with _LOCK:
            _SPANS[self.name] += 1
        _stack().append(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        _stack().pop()
        return False


def span(name: str):
    """A span named `sharp.<name>` while a profiler records; a shared no-op
    context otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def sub(name: str):
    """A span named after the innermost open span of this thread and `name`
    (`fold` and "select" -> `sharp.fold.select`), or `name` alone at the
    top: for code that several layers call, whose idle gaps must still say
    which layer they are in."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    st = _stack()
    return _Span(f"{st[-1]}.{name}" if st else name)


def host_read(x: torch.Tensor, site: str):
    """x on the host: a Python number for a 0-d tensor (`.item()`), else a
    CPU tensor (`.cpu()`). While tracing, counted under `site` and under
    every span open on this thread."""
    if _profiler._is_profiler_enabled:
        with _LOCK:
            _READS[site] += 1
            for name in set(_stack()):
                _READS_UNDER[name] += 1
    return x.item() if x.dim() == 0 else x.cpu()


def add(key: str, n) -> None:
    """Add a host number to the sum `key` while tracing."""
    if _profiler._is_profiler_enabled:
        with _LOCK:
            _SUMS[key] += n


def add_device(key: str, t: torch.Tensor) -> None:
    """Add a 0-d device tensor to the sum `key` while tracing, on the
    device: `snapshot()` reads it."""
    if not _profiler._is_profiler_enabled:
        return
    with _LOCK:
        acc = _DEVICE_SUMS.get((key, t.device))
        if acc is None:
            _DEVICE_SUMS[(key, t.device)] = t.detach().to(torch.float64, copy=True)
        else:
            acc.add_(t)


class _Kernel:
    __slots__ = ("name", "events")

    def __init__(self, name: str):
        self.name = name
        self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        self.events[0].record()
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.events[1].record()
            with _LOCK:
                _EVENTS.setdefault(self.name, []).append(self.events)
        return False


def kernel(name: str):
    """While tracing, a CUDA event pair on the current stream around a
    hand-written kernel's launch call. The pair holds the call too: on an
    idle stream the start event completes before the kernel is launched,
    and a kernel that ends before the host records the end event leaves
    the host's time in the pair; it never reads less than the kernel's
    time."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Kernel(name)


def snapshot() -> dict:
    """What the tracer counted since the last `reset()`:

    spans             {name: calls}
    host_reads        {site: reads}
    host_reads_under  {span name: reads made while it was open}
    sums              {key: value}: host sums and device sums read now,
                      such as "ladder.live_lane_rounds"
    kernels           {name: {"bytes", "ms"}}: the kernel's bytes, and ms
                      from its CUDA event pairs, read now (0 without
                      pairs: on the CPU, and the cut replay)
    """
    with _LOCK:
        pending = {k: list(v) for k, v in _EVENTS.items()}
        _EVENTS.clear()
        device_sums = list(_DEVICE_SUMS.items())
        _DEVICE_SUMS.clear()
    ms = Counter()
    for name, pairs in pending.items():
        for start, end in pairs:
            end.synchronize()
            ms[name] += start.elapsed_time(end)
    read = Counter()
    for (key, _), acc in device_sums:
        read[key] += acc.item()
    with _LOCK:
        _KERNEL_MS.update(ms)
        _SUMS.update(read)
        sums = {k: v for k, v in _SUMS.items() if not k.endswith(BYTES)}
        names = {k[:-len(BYTES)] for k in _SUMS if k.endswith(BYTES)} | set(_KERNEL_MS)
        kernels = {k: {"bytes": _SUMS[k + BYTES], "ms": _KERNEL_MS[k]} for k in names}
        return {"spans": dict(_SPANS), "host_reads": dict(_READS), "host_reads_under": dict(_READS_UNDER),
                "sums": sums, "kernels": kernels}


def reset() -> None:
    """Clear everything the tracer counted."""
    with _LOCK:
        for c in (_SPANS, _READS, _READS_UNDER, _SUMS, _KERNEL_MS):
            c.clear()
        _DEVICE_SUMS.clear()
        _EVENTS.clear()


# --- stages -----------------------------------------------------------------

class StageTimer:
    """Accumulates wall-clock per named stage; cheap enough to always run.
    Each stage is also the tracer's span `<layer>.<stage>`."""

    def __init__(self, layer: str) -> None:
        self.layer = layer
        self.records: List[Dict] = []
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        log(f"stage {name} ...")
        try:
            with span(f"{self.layer}.{name}"):
                yield
        finally:
            dt = time.perf_counter() - t
            self.records.append({"stage": name, "seconds": dt})
            log(f"stage {name} done in {dt:.3f}s")

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def as_dict(self) -> Dict:
        return {
            "total_seconds": self.total(),
            "stages": list(self.records),
        }
