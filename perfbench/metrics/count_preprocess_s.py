"""`count_preprocess_s`: `core/pipeline.preprocess`, the `preprocess`
stage of each `sharp()` call (`SharpResult.timing["stages"]`, the
program's `StageTimer`, whose span is `sharp.small.preprocess`: the clamp,
the all-zero-gene drop and CPM on the host), the median over the window's
calls."""

import statistics


def read(ctx):
    vals = [r["stages"]["preprocess"] for r in ctx.records if "preprocess" in r.get("stages", {})]
    return statistics.median(vals) if vals else None
