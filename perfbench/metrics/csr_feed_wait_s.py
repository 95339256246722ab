"""`csr_feed_wait_s`: the caller's waits for the sparse feed's staged fold
groups in each `sharp_unlimited()` call, summed (the span
`sharp.fold_pass.wait`, whose seconds the program adds up in
`SharpResult.timing["fold_pass"]["wait_s"]` with no synchronise: the
feed's exposed part), the median over the window's calls. None where the
program does not report them."""

from perfbench.metrics._common import median_of


def read(ctx):
    return median_of(ctx, "csr_feed_wait_s")
