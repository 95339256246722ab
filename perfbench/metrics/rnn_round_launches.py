"""`rnn_round_launches`: launches of the ladder's round kernel a solution
(`ops.linkage_cuda.LAUNCHES["rnn_round"]`), the median over the window."""

import statistics


def read(ctx):
    vals = [r["launches"]["rnn_round"] for r in ctx.records if "launches" in r]
    return statistics.median(vals) if vals else None
