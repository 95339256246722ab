"""One intra-op torch thread for every CPU test module of the port.

A test file of the port imports the fixture, which then runs once for each
module that imports it and puts the previous count back after the module:

    from torch_threads import one_torch_thread  # noqa: F401

The port's CPU paths are thousands of small tensor operations (the ladder's
rounds, the selection sweeps, the t-SNE loop). Under the suite's parallel
workers a pool of one intra-op thread per core for each operation
oversubscribes the host: six workers of eight threads each on eight cores.
So one case of the ladder's round test took 714-1,155 s in the suite (7 s
alone, 21 s in the suite on one thread), and `test_torch_trace.py` took
610 s in the suite against 49 s alone on eight threads and 52 s alone on
one (58 s of CPU time instead of 209 s). Worker processes that a test
starts set their own thread count.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
