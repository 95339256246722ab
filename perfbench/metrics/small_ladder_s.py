"""`small_ladder_s`: `ops/linkage.ward_linkage_rnn` on the small tier,
the seconds of the program's CUDA event pair around the ladder's rounds
and tail (`timers.kernel("ladder")`) per profiled `sharp()` call (the
tracer's `sharp.api` spans over the profiled passes). A program without
the pair gives None."""

from perfbench.metrics._program import snapshot


def read(ctx):
    snap = snapshot()
    k = snap["kernels"].get("ladder") if snap else None
    calls = snap["spans"].get("api", 0) if snap else 0
    return k["ms"] / 1e3 / calls if k and k["ms"] and calls else None
