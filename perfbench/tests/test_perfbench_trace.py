"""Reading a trace of the card's activity alone: the window lies between
the two `torch.cuda._sleep` kernels, and the busy time is the union of the
device operations inside it, the marks left out."""

from types import SimpleNamespace

import pytest

from perfbench.lib.trace import MARK, device_only


class _Event:
    def __init__(self, name, start, end, device="DeviceType.CUDA"):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return False


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))


def test_device_only_spans_the_marks():
    ev = [_Event("before", 0, 50), _Event(MARK, 100, 101), _Event("gemm", 200, 600),
          _Event("gemm", 500, 700), _Event("copy", 900, 1000), _Event("cudaLaunchKernel", 150, 160, "DeviceType.CPU"),
          _Event(MARK, 1999, 2000), _Event("after", 2100, 2200)]
    busy, window, ops, n = device_only(_prof(ev))
    assert window == pytest.approx(1900e-9)
    assert busy == pytest.approx(600e-9)           # [200, 700] and [900, 1000]
    assert ops[0] == ["gemm", pytest.approx(600e-9)] and n == 3


def test_device_only_needs_both_marks():
    with pytest.raises(RuntimeError):
        device_only(_prof([_Event(MARK, 0, 1), _Event("gemm", 2, 3)]))
