"""The cell `pbmc4k_4340.count_calls` at a small configuration on the CPU:
its traffic's set-up, calls and check through the harness, on both
linkage routes; each number of the check failing for an answer altered
where the check reads it; its per-layer metrics from a traced run (the
preprocess stage; the ladder's event pair needs a card). On the card
(`cuda`): a traced run of a smaller sample at the cell's widths passes its
check and reads all three of the cell's per-layer metrics."""

import numpy as np
import pytest
import torch

from perfbench.lib import registry
from perfbench.lib.spans import Spans
from perfbench.run import run_cell

CELL = "pbmc4k_4340.count_calls"
CPU = torch.device("cpu")
SEED = 2**31 + 4340
METRICS = {"count_preprocess_s", "small_ladder_s", "ladder_pair_fill_pct"}
CHECKS = {"label_gap", "k_gap", "viE_err", "maxsil_err"}


def _small(linkage_backend="auto"):
    """The configuration's sample at 230 cells (n_pad 256) and 400 genes."""
    return {**registry.config("pbmc4k_4340"), "n_cells": 230, "n_genes": 400, "ensize_K": 3, "reduced_ndim": 32,
            "linkage_backend": linkage_backend}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def solved():
    """The traffic set up, with two answers."""
    wl = registry.workload(CELL)
    drv = registry.driver(wl)(_small(), wl["params"], SEED, CPU, Spans(False))
    drv.setup()
    recs = [drv.solve(), drv.solve()]
    return drv, recs


@pytest.mark.parametrize("route", ["auto", "rnn"])
def test_port_outputs_pass(route):
    res = run_cell(CELL, SEED, 1.0, False, dev=CPU, cfg=_small(route))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"cells_per_s", "setup_s"}
    assert set(res["checks"]) == CHECKS
    info = res["info"]
    assert 0 < info["genes_kept"] < 400 and info["detected_genes_per_cell"] > 0


def _alter(answer, what):
    a = dict(answer)
    if what == "one_label_moved":
        a["labels"] = a["labels"].copy()
        a["labels"][0] = a["labels"][0] % a["labels"].max() + 1
    elif what == "member_k_changed":
        a["k_per"] = a["k_per"].copy()
        a["k_per"][0] += 1
    elif what == "maxsil_off_1e-4":
        a["maxsil"] = a["maxsil"] + np.float32(1e-4)
    elif what == "viE_off_1e-4":
        a["viE"] = a["viE"] * np.float32(1 + 1e-4)
    return a


@pytest.mark.parametrize("what,number", [
    ("one_label_moved", "label_gap"), ("member_k_changed", "k_gap"), ("maxsil_off_1e-4", "maxsil_err"),
    ("viE_off_1e-4", "viE_err"),
])
def test_each_check_number_fails_for_an_altered_answer(solved, what, number):
    drv, recs = solved
    sound = drv.check(recs)
    assert all(c["ok"] for c in sound.values()), sound
    kept = list(drv.answers)
    drv.answers[:] = [_alter(a, what) for a in kept]      # whichever answer the check draws
    try:
        checks = drv.check(recs)
    finally:
        drv.answers[:] = kept
    assert not checks[number]["ok"], checks


def test_traced_run_reports_the_preprocess():
    """On the CPU at n_pad 256 the ladder has no round (its levels compact
    at 256) and no event pair: the preprocess stage alone is read."""
    res = run_cell(CELL, SEED, 1.0, True, dev=CPU, cfg=_small("rnn"))
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"count_preprocess_s"} and res["metrics"]["count_preprocess_s"]["value"] > 0


def test_set_up_refuses_a_configuration_that_states_other_knobs():
    wl = registry.workload(CELL)
    drv = registry.driver(wl)({**_small(), "prep": False}, wl["params"], SEED, CPU, Spans(False))
    with pytest.raises(ValueError, match="other knobs"):
        drv.setup()


@pytest.mark.cuda
def test_traced_run_reads_every_metric_on_the_card():
    """On the card, 2,000 cells (n_pad 2048, the ladder) of the cell's
    33,694 genes at K=15, p=303: the check passes and the traced run reads
    the preprocess, the ladder's seconds and its pair fill."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = {**registry.config("pbmc4k_4340"), "n_cells": 2000}
    res = run_cell(CELL, SEED, 2.0, True, dev=torch.device("cuda", 0), cfg=cfg)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert set(m) == METRICS
    assert m["count_preprocess_s"]["value"] > 0 and m["small_ladder_s"]["value"] > 0
    assert 0 < m["ladder_pair_fill_pct"]["value"] <= 100
