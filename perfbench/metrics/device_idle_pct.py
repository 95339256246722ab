"""`device_idle_pct`: the share of the profiled segment in which no
operation ran on the card (the union of the device intervals of a trace
of the card's activity alone, against the segment's length)."""


def read(ctx):
    if not ctx.trace or ctx.trace.window_s <= 0 or ctx.trace.device_events == 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
