"""The cell `atlas_csr_1p3m.unlimited_calls` at a small configuration on
the CPU: its traffic's set-up, calls and check through the harness; each
number of the check failing for an answer altered where the check reads
it; its per-layer metrics from a traced run; a program whose
`sharp_unlimited` takes no `rM` refused before any data is made. On the
card (`cuda`): a small version of the cell passes its check with the sparse
feed on page-locked buffers, and the control (TF32 products) fails it."""

import numpy as np
import pytest
import torch

from perfbench.lib import registry
from perfbench.lib.spans import Spans
from perfbench.run import run_cell

CELL = "atlas_csr_1p3m.unlimited_calls"
CPU = torch.device("cpu")
SEED = 2**31 + 5151
# the cell's shapes at 1,900 cells: blocks of 600, 600 and 700, folds of 200
# at n_pad 256, 40 nonzeros a cell
CSR_SMALL = dict(n_cells=1900, n_genes=300, block_cells=600, n_types=5, nnz_per_cell=40, ensize_K=3,
                 reduced_ndim=32, partition_ncells=200, maxN_cluster=40, dtype_compute="float32", forview=False,
                 linkage_backend="auto", knobs=dict(ensize_K=3, reduced_ndim=32, partition_ncells=200))
CHECKS = {"fold_gap", "centroid_err", "count_gap", "fold_label_gap", "k_gap", "maxsil_err", "block_label_gap",
          "final_label_gap"}


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


@pytest.fixture(scope="module")
def solved():
    """The traffic set up, with two answers."""
    wl = _wl()
    drv = registry.driver(wl)(CSR_SMALL, wl["params"], SEED, CPU, Spans(False))
    drv.setup()
    recs = [drv.solve(), drv.solve()]
    return drv, recs


def test_port_outputs_pass():
    res = run_cell(CELL, SEED, 1.0, False, dev=CPU, wl=_wl(), cfg=CSR_SMALL)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"cells_per_s", "setup_s"}
    assert set(res["checks"]) == CHECKS
    assert res["info"]["ari_vs_planted"] > 0.5 and res["info"]["host_csr_gib"] > 0


def _alter(answer, what):
    a = dict(answer)
    rng = np.random.default_rng(0)
    if what == "fold_labels_permuted":
        a["fold_labels"] = a["fold_labels"].copy()
        a["fold_labels"][:200] = rng.permutation(a["fold_labels"][:200])
    elif what == "cent_sum_off_1e-4":
        a["cent_sum"] = a["cent_sum"] * np.float32(1 + 1e-4)
    elif what == "counts_shifted":
        a["counts"] = a["counts"].copy()
        a["counts"][-1, 0] += 1
    elif what == "member_k_shifted":
        a["k_per"] = a["k_per"].copy()
        a["k_per"][-1, 0] += 1
    elif what == "maxsil_off_1e-4":
        a["maxsil"] = a["maxsil"] + np.float32(1e-4)
    elif what == "folds_swapped":
        a["folds"] = a["folds"].copy()
        a["folds"][[0, 250]] = a["folds"][[250, 0]]
    elif what == "block_labels_permuted":
        a["block_labels"] = a["block_labels"].copy()
        a["block_labels"][:600] = rng.permutation(a["block_labels"][:600])
    elif what == "labels_permuted":
        a["labels"] = rng.permutation(a["labels"])
    return a


@pytest.mark.parametrize("what,number", [
    ("fold_labels_permuted", "fold_label_gap"), ("cent_sum_off_1e-4", "centroid_err"),
    ("counts_shifted", "count_gap"), ("member_k_shifted", "k_gap"), ("maxsil_off_1e-4", "maxsil_err"),
    ("folds_swapped", "fold_gap"), ("block_labels_permuted", "block_label_gap"),
    ("labels_permuted", "final_label_gap"),
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


def test_traced_run_reports_its_metrics():
    """The program's two readers from the window's calls; the link share
    needs a device trace, so reads nothing on the CPU. The profiled call's
    feed counts: every nonzero, no page-locked wire on the CPU."""
    res = run_cell(CELL, SEED, 1.0, True, dev=CPU, wl=_wl(), cfg=CSR_SMALL)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["unlimited_block_pass_s"]["value"] > 0 and m["csr_feed_wait_s"]["value"] >= 0
    assert "csr_copy_link_pct" not in m
    counts = res["info"]["feed_counts"]
    assert counts["feed.nnz"] == CSR_SMALL["n_cells"] * CSR_SMALL["nnz_per_cell"]
    assert counts["feed.wire_bytes"] > 0 and counts["feed.wire_pinned_bytes"] == 0


def test_program_without_rM_is_refused_before_any_data(monkeypatch):
    import sharp_tpu_torch

    monkeypatch.setattr(sharp_tpu_torch, "sharp_unlimited", lambda blocks, *, device="cuda", **knobs: None)
    wl = _wl()
    drv = registry.driver(wl)(CSR_SMALL, wl["params"], SEED, CPU, Spans(False))
    with pytest.raises(TypeError, match="takes no rM"):
        drv.setup()
    assert not hasattr(drv, "blocks")


def test_set_up_refuses_a_configuration_that_states_other_knobs():
    wl = _wl()
    drv = registry.driver(wl)({**CSR_SMALL, "maxN_cluster": 50}, wl["params"], SEED, CPU, Spans(False))
    with pytest.raises(ValueError, match="other knobs"):
        drv.setup()


@pytest.mark.cuda
def test_small_cell_passes_and_its_control_fails_on_the_card():
    """On the card, at 12,000 cells in three blocks with the cell's 27,998
    genes and 2,048 nonzeros a cell (sharp_unlimited's own knobs at that
    size): the check passes, the sparse feed copies every wire byte from
    page-locked memory, and with the program's float32 products in TF32
    (the control) at least one number fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    cfg = {**registry.config("atlas_csr_1p3m"), "n_cells": 12000, "block_cells": 4000, "reduced_ndim": 339,
           "maxN_cluster": 40}
    res = run_cell(CELL, SEED, 2.0, True, dev=dev, wl=_wl(), cfg=cfg)
    assert res["correct"], res["checks"]
    counts = res["info"]["feed_counts"]
    assert counts["feed.wire_pinned_bytes"] == counts["feed.wire_bytes"] > 0
    control = run_cell(CELL, SEED, 2.0, False, dev=dev, wl=_wl(), cfg=cfg, control=True)
    assert not control["correct"], control["checks"]
