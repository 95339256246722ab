"""`ensemble_cluster_s`: the small-tier driver's `ensemble_cluster` stage
of each call (its own host clock, a stage that ends in a read of its
result), the median over the window's calls."""

from perfbench.metrics._common import median_of


def read(ctx):
    return median_of(ctx, "ensemble_cluster_s")
