"""`scripts/pbmc_routes.py` on the CPU at a small configuration of the
pbmc4k cell (230 cells at n_pad 256, 300 genes, K=3, p=32; a sample with
next to no recoverable types): both modes write one record a seed, every
route is held to the plain reference, and in card mode the reference's
greedy Ward on the port's own distances gives the port's serial tree on
every member. One torch thread."""

import json
import os
import subprocess
import sys

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import pbmc_routes  # noqa: E402

SMALL = {"n_cells": 230, "n_genes": 300, "ensize_K": 3, "reduced_ndim": 32}
WEAK = {"marker_pool": 140, "markers": 3, "marker_lfc": [1.5, 4.0]}
NUMBERS = {"label_gap", "k_gap", "maxsil_err", "viE_err"}


def test_card_mode_holds_both_routes_and_locates_the_parting():
    rec = pbmc_routes.routes(2**31 + 30, "card", torch.device("cpu"), WEAK, SMALL)
    assert set(rec["cell"]) == set(rec["serial"]) == NUMBERS
    assert rec["cell"]["k_gap"] == rec["serial"]["k_gap"] == 0
    assert rec["cell"]["viE_err"] <= 1e-5
    # at n_pad 256 the cell's route is serial Ward: one answer
    assert rec["routes"]["cell_vs_serial"]["label_gap"] == 0
    assert 0 < rec["distance_gap"] <= 1e-6
    parting = rec["first_parting_merge"]
    assert parting["cell_vs_serial"] == [-1] * 3
    assert parting["greedy_on_port_distances_vs_serial"] == [-1] * 3


def test_cpu_mode_runs_the_whole_call_on_the_host_from_the_command_line():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "pbmc_routes.py"), "cpu", "7,8", "--device", "cpu",
         "--threads", "1", "--umi", json.dumps(WEAK), "--cfg", json.dumps(SMALL)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    recs = [json.loads(line) for line in out.stdout.splitlines()]
    assert [r["seed"] for r in recs] == [7, 8]
    for r in recs:
        assert r["mode"] == "cpu" and set(r["cpu"]) == NUMBERS
        assert r["routes"]["cell_vs_cpu"] == {"label_gap": 0.0, "k_gap": 0.0, "maxsil_err": 0.0, "viE_err": 0.0}
        assert "distance_gap" not in r
