"""Helpers of the per-layer metric readers."""

import statistics


def median_per_solution(ctx, prefix):
    """Median over the window's solutions of their spans named `prefix`*."""
    per = {s: v for s, v in ctx.spans.per_solution(prefix).items() if s >= 0}
    return statistics.median(per.values()) if per else None


def median_of(ctx, key):
    vals = [r[key] for r in ctx.records if r.get(key) is not None]
    return statistics.median(vals) if vals else None
