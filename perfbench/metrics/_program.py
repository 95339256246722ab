"""Reading the program's own tracer (`sharp_tpu_torch.utils.timers`),
which counts only while a profiler records: in a traced run, the two
profiled passes over the segment. A program without the tracer gives
None."""

from perfbench.lib.peaks import for_device, roofline_share


def snapshot():
    try:
        from sharp_tpu_torch.utils.timers import snapshot as read
    except ImportError:
        return None
    return read()


def reads_per_call(span: str):
    """Host reads made under the span `span`, per call of it."""
    snap = snapshot()
    calls = snap["spans"].get(span, 0) if snap else 0
    return snap["host_reads_under"].get(span, 0) / calls if calls else None


def kernel_roofline(ctx, name: str):
    """A kernel's share of its roofline: the bytes the program counted over
    HBM bandwidth against the CUDA-event time of its launch calls (None on
    the CPU)."""
    snap = snapshot()
    k = snap["kernels"].get(name) if snap else None
    if not k or not k["ms"] or not k["bytes"]:
        return None
    share, _ = roofline_share(0.0, k["bytes"], k["ms"] / 1e3, for_device(ctx.device["kind"]), "fp32_flops")
    return share
