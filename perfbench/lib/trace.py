"""Reading a torch.profiler trace held in memory: the device's busy time
over the traced window, the device operations that took most time, the
idle gaps by what the host was doing, device-to-host copies, and the
device time of the kernels launched under a named annotation.

A trace of host and device activity (`summarize`) spans the annotation
`perfbench.window` on the thread that opened it. A trace of device
activity alone (`device_only`), which costs the host little, spans two
`torch.cuda._sleep` kernels launched at its ends. Nothing is written to
disk.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Sequence

WINDOW = "perfbench.window"
MARK = "spin_kernel"        # the kernel of torch.cuda._sleep


class TraceSummary(NamedTuple):
    busy_s: float                      # union of device operations inside the window
    window_s: float
    device_ops: List[list]             # [[name, seconds], ...] most time first, at most 10
    idle_gaps: List[list]              # [[host activity, idle seconds], ...] most first, at most 10
    dtoh_copies: int                   # device-to-host copies inside the window
    annotation_device_s: Dict[str, float]  # device seconds of kernels launched under each annotation
    device_events: int


def _is_cpu(e) -> bool:
    return str(e.device_type()).endswith("CPU")


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _busy_and_ops(inside):
    """Union of device intervals (start, end, name, ...) -> (busy intervals,
    the 10 operations that took most time as [[name, seconds], ...])."""
    per_op = defaultdict(float)
    for s, e, n, *_ in inside:
        per_op[n] += (e - s) / 1e9
    return _union([(s, e) for s, e, *_ in inside]), [[n, t] for n, t in sorted(per_op.items(), key=lambda x: -x[1])[:10]]


def device_only(prof):
    """A finished profile of device activity alone, whose segment lies
    between the first and the last `torch.cuda._sleep` kernel -> (busy
    seconds, window seconds, device operations, device events)."""
    dev = [(e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
           if not _is_cpu(e) and not e.is_user_annotation() and not e.name().startswith("perfbench.")]
    marks = sorted((s, e) for s, e, n in dev if MARK in n)
    if len(marks) < 2:
        raise RuntimeError(f"the device trace holds {len(marks)} {MARK} kernels, not two")
    ws, we = marks[0][0], marks[-1][1]
    inside = [(max(s, ws), min(e, we), n) for s, e, n in dev if e > ws and s < we and MARK not in n]
    busy, ops = _busy_and_ops(inside)
    return sum(e - s for s, e in busy) / 1e9, (we - ws) / 1e9, ops, len(inside)


def _host_activity(cpu, queries):
    """For each query time, the innermost host event that covers it on the
    window's thread, named '<annotation> > <op>'."""
    cpu = sorted(cpu, key=lambda x: (x[0], -x[1]))
    order = sorted(range(len(queries)), key=lambda i: queries[i])
    names = [None] * len(queries)
    stack, k = [], 0
    for qi in order:
        m = queries[qi]
        while k < len(cpu) and cpu[k][0] <= m:
            ev = cpu[k]
            while stack and stack[-1][1] <= ev[0]:
                stack.pop()
            stack.append(ev)
            k += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        ann = next((e[2] for e in reversed(stack) if e[3] and e[2] != WINDOW), None)
        top = stack[-1] if stack else None
        op = "(python)" if top is None or top[3] else top[2]
        names[qi] = f"{ann} > {op}" if ann else op
    return names


def summarize(prof, annotations: Sequence[str] = ()) -> TraceSummary:
    """Summary of a finished `torch.profiler.profile` whose traced work ran
    inside `record_function(WINDOW)`."""
    events = prof.profiler.kineto_results.events()
    cpu, dev = [], []
    win = None
    for e in events:
        if _is_cpu(e):
            if e.is_async():
                continue
            rec = (e.start_ns(), e.end_ns(), e.name(), bool(e.is_user_annotation()),
                   e.start_thread_id(), e.correlation_id(), e.linked_correlation_id())
            cpu.append(rec)
            if rec[2] == WINDOW:
                win = rec
        elif not (e.is_user_annotation() or e.name().startswith("perfbench.")):
            # device-side copies of the host's annotations are no device work
            dev.append((e.start_ns(), e.end_ns(), e.name(), e.linked_correlation_id()))
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW} annotation")
    ws, we, thread = win[0], win[1], win[4]
    cpu = [c for c in cpu if c[4] == thread]
    inside = [(max(s, ws), min(e, we), n, c) for s, e, n, c in dev if e > ws and s < we]
    busy, device_ops = _busy_and_ops(inside)
    busy_ns = sum(e - s for s, e in busy)

    edges = [ws] + [x for iv in busy for x in iv] + [we]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    names = _host_activity(cpu, [(a + b) // 2 for a, b in gaps])
    per_gap = defaultdict(float)
    for (a, b), n in zip(gaps, names):
        per_gap[n] += (b - a) / 1e9
    idle_gaps = [[n, t] for n, t in sorted(per_gap.items(), key=lambda x: -x[1])[:10]]

    ann_s = {}
    starts = sorted((c[0], c[5]) for c in cpu if not c[3] and c[6] == 0)
    keys = [s for s, _ in starts]
    for name in annotations:
        ids = set()
        for s, e, n, is_ann, _, _, _ in cpu:
            if is_ann and n == name:
                lo, hi = bisect.bisect_left(keys, s), bisect.bisect_right(keys, e)
                ids.update(cid for _, cid in starts[lo:hi])
        ann_s[name] = sum((e - s) / 1e9 for s, e, _, c in inside if c in ids) if ids else 0.0
    return TraceSummary(
        busy_s=busy_ns / 1e9, window_s=(we - ws) / 1e9, device_ops=device_ops, idle_gaps=idle_gaps,
        dtoh_copies=sum(1 for _, _, n, _ in inside if "DtoH" in n or "Device -> Host" in n),
        annotation_device_s=ann_s, device_events=len(inside),
    )
