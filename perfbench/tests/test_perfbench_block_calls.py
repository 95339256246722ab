"""The cell `atlas_block_50k.block_calls` at a small configuration on the
CPU: its traffic's set-up, calls and check through the harness; each number
of the check failing for an answer altered where the check reads it; the
benchmark's byte count against the program's tracer; its per-layer
metrics; and the cell on a program that reports no feed seconds (as
before they existed). The share of the host link needs the card: the
`cuda` test at the end."""

import numpy as np
import pytest
import torch

from perfbench.lib import registry
from perfbench.lib.spans import Spans
from perfbench.run import run_cell

CELL = "atlas_block_50k.block_calls"
CPU = torch.device("cpu")
SEED = 2**31 + 4242
KNOBS = dict(base_ncells=500, partition_ncells=200, ensize_K=3, reduced_ndim=32, prep=False, log_transform=True)
# the cell's shapes at 1,200 cells: six folds of 200 at n_pad 256
BLOCK_SMALL = dict(n_cells=1200, n_genes=300, n_types=5, ensize_K=3, reduced_ndim=32, partition_ncells=200,
                   maxN_cluster=40, prep=False, dtype_compute="float32", forview=True, linkage_backend="auto",
                   knobs=KNOBS)
PAD = 256


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wl():
    wl = registry.workload(CELL)
    wl["params"] = dict(wl["params"])
    return wl


def _run(trace=False, cfg=BLOCK_SMALL):
    return run_cell(CELL, SEED, 1.0, trace, dev=CPU, wl=_wl(), cfg=cfg)


@pytest.fixture(scope="module")
def solved():
    """The traffic set up, with two answers."""
    wl = _wl()
    drv = registry.driver(wl)(BLOCK_SMALL, wl["params"], SEED, CPU, Spans(False))
    drv.setup()
    recs = [drv.solve(), drv.solve()]
    return drv, recs


def test_port_outputs_pass():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"cells_per_s", "setup_s"}
    assert set(res["checks"]) == {"fold_gap", "k_gap", "maxsil_err", "viE_err", "label_gap"}
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], name
    assert res["info"]["host_peak_rss_gib"] > 0 and res["info"]["ari_vs_planted"] > 0.5


def _alter(answer, what):
    a = dict(answer)
    if what == "permuted_labels":
        a["labels"] = np.random.default_rng(0).permutation(a["labels"])
    elif what == "viE_off_1e-4":
        a["viE"] = a["viE"] * np.float32(1 + 1e-4)
    elif what == "member_k_shifted":
        a["k_per"] = a["k_per"].copy()
        a["k_per"][0, 0] += 1
    elif what == "maxsil_off_1e-4":
        a["maxsil"] = a["maxsil"] + np.float32(1e-4)
    elif what == "folds_swapped":
        a["folds"] = a["folds"].copy()
        i, j = int(np.argmax(a["folds"] == 0)), int(np.argmax(a["folds"] == 1))
        a["folds"][[i, j]] = a["folds"][[j, i]]
    return a


@pytest.mark.parametrize("what,number", [
    ("permuted_labels", "label_gap"), ("viE_off_1e-4", "viE_err"), ("member_k_shifted", "k_gap"),
    ("maxsil_off_1e-4", "maxsil_err"), ("folds_swapped", "fold_gap"),
])
def test_each_check_number_fails_for_an_altered_answer(solved, what, number):
    drv, recs = solved
    sound = drv.check(recs)
    assert all(c["ok"] for c in sound.values()), sound
    kept = drv.answers[-1]
    drv.answers[-1] = _alter(kept, what)       # the last answer is always checked
    try:
        checks = drv.check(recs)
    finally:
        drv.answers[-1] = kept
    assert not checks[number]["ok"], checks


def test_byte_count_matches_the_tracer(solved):
    """The benchmark's bytes a call equal the tracer's bytes copied less
    the pad rows; the live rows gathered are the same bytes."""
    from sharp_tpu_torch.utils import timers

    drv, _ = solved
    timers.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        drv.profile_segment()
    sums = timers.snapshot()["sums"]
    timers.reset()
    c = BLOCK_SMALL
    calls = drv.p["profile_calls"]
    folds = c["n_cells"] // c["partition_ncells"]
    pad_bytes = calls * folds * (PAD - c["partition_ncells"]) * c["n_genes"] * 4
    per_call = drv.layer_context()["input_bytes_per_call"]
    assert calls * per_call == sums["feed.copied_bytes"] - pad_bytes == sums["feed.gathered_bytes"]
    assert drv.lanes == [folds] * calls


def test_traced_run_reports_its_metrics():
    """The program's two readers from the window's calls; the link share
    needs a device trace, so reads nothing on the CPU."""
    res = _run(trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert 0 < m["dense_feed_s"]["value"] <= m["fold_ensemble_s"]["value"]
    assert "dense_copy_link_pct" not in m


def test_program_without_feed_seconds(monkeypatch):
    """A program whose result carries no `timing["fold_pass"]`: the feed's
    reader gives nothing and the run stays whole."""
    import sharp_tpu_torch.api as api

    inner = api.sharp_large

    def without(*a, **k):
        res = inner(*a, **k)
        res.timing.pop("fold_pass")
        return res

    monkeypatch.setattr(api, "sharp_large", without)
    res = _run(trace=True)
    assert res["correct"] and "dense_feed_s" not in res["metrics"] and "fold_ensemble_s" in res["metrics"]


def test_set_up_refuses_a_configuration_that_states_other_knobs():
    wl = _wl()
    drv = registry.driver(wl)({**BLOCK_SMALL, "maxN_cluster": 50}, wl["params"], SEED, CPU,
                              Spans(False))
    with pytest.raises(ValueError, match="other knobs"):
        drv.setup()


@pytest.mark.cuda
def test_feed_is_pageable_and_link_share_reads_on_the_card():
    """On the card, at the small configuration with the cell's 27,998 genes
    (so that the copies are among the trace's leading device operations,
    which the reader reads): today's feed copies from pageable memory only,
    and the copies' share of the link reads in (0, 100]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sharp_tpu_torch.utils import timers

    dev = torch.device("cuda", 0)
    cfg = {**BLOCK_SMALL, "n_genes": 27998}
    wl = _wl()
    drv = registry.driver(wl)(cfg, wl["params"], SEED, dev, Spans(False))
    drv.setup()
    timers.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        drv.profile_segment()
    sums = timers.snapshot()["sums"]
    timers.reset()
    assert sums["feed.pageable_bytes"] == sums["feed.copied_bytes"] > 0
    res = run_cell(CELL, SEED, 2.0, True, dev=dev, wl=_wl(), cfg=cfg)
    assert res["correct"], res["checks"]
    assert 0 < res["metrics"]["dense_copy_link_pct"]["value"] <= 100
