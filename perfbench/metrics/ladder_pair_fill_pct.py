"""`ladder_pair_fill_pct`: the pairs the ladder's rounds merged over the
pair slots they had (`pair_cap` P per active lane-round), from the
program's tracer over the profiled passes (`ladder.pairs`,
`ladder.pair_slots`): near 100, the rounds are capped by P; low, they are
starved (the pad rounds, the last rounds of a level). A program without
the sums gives None."""

from perfbench.metrics._program import snapshot


def read(ctx):
    snap = snapshot()
    sums = snap["sums"] if snap else {}
    slots = sums.get("ladder.pair_slots", 0)
    return 100.0 * sums.get("ladder.pairs", 0) / slots if slots else None
