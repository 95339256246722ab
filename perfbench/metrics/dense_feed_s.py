"""`dense_feed_s`: the dense feed's host seconds in each `sharp()` call, the
gather of the fold groups' rows and the copy's call
(`SharpResult.timing["fold_pass"]`: `slice_s + transfer_s`, read by the
program with no synchronise), the median over the window's calls. None
where the program does not report them."""

from perfbench.metrics._common import median_of


def read(ctx):
    return median_of(ctx, "dense_feed_s")
