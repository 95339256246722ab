"""`csr_copy_link_pct`: the sparse feed's host-to-device copies' share of
the host link in the profiled call. Work: the triplet buffers the feed
copied in the call (the program's tracer count `feed.wire_bytes`, the
cell's `wire_bytes_per_call`). Time: the device seconds of the
host-to-device copies among the card-only trace's leading device
operations. Against the H100's PCIe 5.0 x16 host link, one way, as
`dense_copy_link_pct` reads the dense feed. None where the program counts
no wire bytes."""

from perfbench.metrics.dense_copy_link_pct import LINK_BYTES_PER_S, _is_htod


def read(ctx):
    per_call = getattr(ctx, "wire_bytes_per_call", None)
    if not ctx.trace or not ctx.profiled or not per_call:
        return None
    seconds = sum(s for name, s in ctx.trace.device_ops if _is_htod(name))
    if not seconds:
        return None
    return 100.0 * per_call * len(ctx.profiled) / seconds / LINK_BYTES_PER_S
