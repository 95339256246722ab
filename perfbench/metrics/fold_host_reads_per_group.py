"""`fold_host_reads_per_group`: host reads made inside the fold program
(`sharp.fold` spans), per fold-program call, from the program's tracer."""

from perfbench.metrics._program import reads_per_call


def read(ctx):
    return reads_per_call("fold")
