"""`fold_ensemble_s`: `core/large.sharp_large`'s `fold_ensemble` stage of each
`sharp()` call (`SharpResult.timing["stages"]`, the program's `StageTimer`,
whose span is `sharp.large.fold_ensemble`: the dense feed, the fold
programs and the summaries' readback, a stage that ends in a read of its
results), the median over the window's calls."""

from perfbench.metrics._common import median_of


def read(ctx):
    return median_of(ctx, "fold_ensemble_s")
