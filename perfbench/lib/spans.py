"""The benchmark's spans: host-clock intervals around its calls into the
program's layers, kept in memory, each also a `record_function`
annotation named `perfbench.<name>` so that a profiler trace sees it.
Off, a span costs nothing and records nothing."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List


class Spans:
    def __init__(self, enabled: bool, sync=None):
        self.enabled = enabled
        self._sync = sync
        self.solution = 0
        self.records: List[tuple] = []      # (solution, name, seconds)

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        """A span; `sync` waits for the device before it closes, for work
        that ends in no read of its own."""
        if not self.enabled:
            yield
            return
        import torch

        with torch.profiler.record_function("perfbench." + name):
            t0 = time.perf_counter()
            yield
            if sync and self._sync is not None:
                self._sync()
            self.records.append((self.solution, name, time.perf_counter() - t0))

    def per_solution(self, prefix: str) -> Dict[int, float]:
        """Seconds of the spans whose name starts with `prefix`, by solution."""
        out = defaultdict(float)
        for sol, name, sec in self.records:
            if name.startswith(prefix):
                out[sol] += sec
        return dict(out)
