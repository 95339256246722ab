"""`host_reads_per_call`: device-to-host copies a call in the profiled
calls (every `.item()`, `int()`, `bool()` of a device value, the
`aten::_local_scalar_dense` behind them, and every `.cpu()` makes one),
from the device trace."""


def read(ctx):
    if not ctx.trace or not ctx.profiled:
        return None
    return ctx.trace.dtoh_copies / len(ctx.profiled)
