"""`unlimited_block_pass_s`: `parallel/streaming.sharp_unlimited`'s
`block_pass` stage of each call (`SharpResult.timing["stages"]`, the
program's `StageTimer`, whose span is `sharp.unlimited.block_pass`: every
block's load, sparse feed, fold programs and batched block fuses), the
median over the window's calls."""

from perfbench.metrics._common import median_of


def read(ctx):
    return median_of(ctx, "block_pass_s")
