"""`rnn_live_lane_pct`: the share of the ladder's launched lane-rounds (L
a round launched) in which the lane was active, from the program's tracer
over the profiled passes."""

from perfbench.metrics._program import snapshot


def read(ctx):
    snap = snapshot()
    sums = snap["sums"] if snap else {}
    launched = sums.get("ladder.launched_lane_rounds", 0)
    return 100.0 * sums.get("ladder.live_lane_rounds", 0) / launched if launched else None
