"""`bench_datagen_s`: seconds a solution inside the benchmark's `datagen` spans, the median
over the window's solutions (host clock; each span closes on a read of
its results or a synchronise)."""

from perfbench.metrics._common import median_per_solution


def read(ctx):
    return median_per_solution(ctx, "datagen")
