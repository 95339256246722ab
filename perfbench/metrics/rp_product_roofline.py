"""`rp_product_roofline`: the RP product's share of its roofline in one
profiled solution. Work: 2 x real cells x genes x K*p operations and the
bytes read once (the log-transformed cells in float32, the RP operand) and
written once (the float32 projection); bound: the larger of operations
over the peak of the operand precision and bytes over HBM bandwidth (H100
data sheet). Time: device time of the kernels launched under the
benchmark's span around each `rp_project_ensemble` call (device trace)."""

from perfbench.lib.peaks import for_device, roofline_share


def read(ctx):
    t = ctx.trace.annotation_device_s.get("perfbench.rp_product", 0.0) if ctx.trace else 0.0
    work = getattr(ctx, "rp_work", None)
    if not t or work is None:
        return None
    share, _ = roofline_share(work["flops"], work["bytes"], t, for_device(ctx.device["kind"]), work["flops_key"])
    return share
