"""`solve_p50_s`: the median call of the window (host clock around each
call, which returns host results)."""

from perfbench.metrics._common import median_of


def read(ctx):
    return median_of(ctx, "seconds")
