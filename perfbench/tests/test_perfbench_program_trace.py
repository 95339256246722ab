"""The readers of the program's own tracer (`sharp_tpu_torch.utils.timers`):
each new metric on a stub `snapshot()`, none from a program without the
tracer, and both cells traced on the CPU at small sizes, where the counts
read and the roofline, which needs the card's events, does not."""

from types import SimpleNamespace

import pytest
import torch

from conftest import ATLAS_SMALL, WANG_SMALL
from perfbench.lib import registry
from perfbench.run import run_cell

ATLAS = "flagship_1p3m.device_fed"
WANG = "wang_pancreas_479.repeat_calls"
NEW = ("rnn_live_lane_pct", "rnn_round_roofline", "fold_host_reads_per_group", "sharp_host_reads_per_call")
H100 = SimpleNamespace(device={"kind": "NVIDIA H100 80GB HBM3"})
STUB = {
    "spans": {"fold": 4, "api": 20},
    "host_reads": {"ladder.active": 48, "pipeline.k_per": 20},
    "host_reads_under": {"fold": 48, "api": 140},
    "sums": {"ladder.live_lane_rounds": 300.0, "ladder.launched_lane_rounds": 1200},
    "kernels": {"rnn_round": {"bytes": 3.35e9, "ms": 4.0}, "cutree": {"bytes": 6.7e8, "ms": 0.4}},
}


@pytest.fixture
def stub(monkeypatch):
    from sharp_tpu_torch.utils import timers

    monkeypatch.setattr(timers, "snapshot", lambda: STUB)


def test_readers_on_a_stub_snapshot(stub):
    got = {name: registry.metric(name)(H100) for name in NEW}
    assert got == pytest.approx({
        "rnn_live_lane_pct": 25.0,            # 300 of 1,200 lane-rounds
        "rnn_round_roofline": 25.0,           # 1 ms at 3.35 TB/s over 4 ms
        "fold_host_reads_per_group": 12.0,
        "sharp_host_reads_per_call": 7.0,
    })


def test_readers_without_counts(monkeypatch):
    """An empty snapshot, a kernel with no event time (the CPU), and a
    program without the tracer read None."""
    from sharp_tpu_torch.utils import timers

    empty = {"spans": {}, "host_reads": {}, "host_reads_under": {}, "sums": {}, "kernels": {}}
    monkeypatch.setattr(timers, "snapshot", lambda: empty)
    assert all(registry.metric(name)(H100) is None for name in NEW)
    cpu = dict(empty, kernels={"rnn_round": {"bytes": 1000, "ms": 0}})
    monkeypatch.setattr(timers, "snapshot", lambda: cpu)
    assert registry.metric("rnn_round_roofline")(H100) is None
    monkeypatch.delattr(timers, "snapshot")
    assert all(registry.metric(name)(H100) is None for name in NEW)


@pytest.mark.parametrize("cell", [ATLAS, WANG])
def test_traced_cpu_run_reads_the_counts(cell):
    """A traced run of each cell on the CPU at a small size (the atlas's
    folds at n_pad 512 on the ladder, two blocks): the counts read, and
    repeat exactly in a second run of the seed; the roofline is None."""
    from sharp_tpu_torch.utils import timers

    wl = registry.workload(cell)
    if cell == ATLAS:
        wl["params"].update(group=4, check_folds=2)
        cfg = dict(ATLAS_SMALL, block_cells=750, partition_ncells=400, linkage_backend="rnn")
        counts = ("rnn_live_lane_pct", "fold_host_reads_per_group")
    else:
        wl["params"].update(profile_calls=2)
        cfg, counts = WANG_SMALL, ("sharp_host_reads_per_call",)
    runs = []
    for _ in range(2):
        timers.reset()
        res = run_cell(cell, 2**31 + 77, 0.5, True, dev=torch.device("cpu"), wl=wl, cfg=cfg)
        runs.append(res["metrics"])
    for name in counts:
        assert runs[0][name]["value"] == runs[1][name]["value"] > 0, name
    assert 0 < runs[0].get("rnn_live_lane_pct", {"value": 50})["value"] < 100
    if cell == WANG:
        assert runs[0]["sharp_host_reads_per_call"]["value"] == 7.0
    assert "rnn_round_roofline" not in runs[0]
