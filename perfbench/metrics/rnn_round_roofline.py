"""`rnn_round_roofline`: the ladder round kernel's share of its roofline
over the profiled passes: the bytes the program counts for its rounds
(each input read once, each output written once, bounded from below where
the count needs a round's matrices) over 3.35 TB/s, against the rounds'
CUDA-event time."""

from perfbench.metrics._program import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "rnn_round")
