"""`sharp_host_reads_per_call`: host reads made inside `sharp()` (its
`sharp.api` span), per call, from the program's tracer."""

from perfbench.metrics._program import reads_per_call


def read(ctx):
    return reads_per_call("api")
