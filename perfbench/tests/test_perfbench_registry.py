"""The benchmark is driven by data: a configuration, a cell, a traffic
driver and a per-layer metric are each added as new files and entries,
and the harness lists, resolves and runs them without an edit to a file
that is there. Also: BENCHMARK.json keeps to the benchmark's contract."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from perfbench.lib import registry
from perfbench.run import run_cell

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

TOY_DRIVER = '''
from perfbench.reference.compare import judge


class Driver:
    annotations = ()

    def __init__(self, cfg, params, seed, dev, spans, control=False):
        self.c, self.p = cfg, params

    def setup(self):
        pass

    def solve(self):
        return {"cells": self.c["n_cells"], "toy": 3.0}

    def profile_segment(self):
        return [self.solve()]

    def layer_context(self):
        return {}

    def release(self):
        pass

    def check(self, records):
        return judge({"same": 0.0}, self.p["limits"])

    def info(self, records):
        return {}
'''


def _digest(folder: Path):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_parts_are_new_files(tmp_path):
    base = tmp_path / "perfbench"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(base)
    (base / "configs" / "toy_cfg.json").write_text(json.dumps({"name": "toy_cfg", "n_cells": 100}))
    (base / "workloads" / "toy_cfg.steady.json").write_text(json.dumps(
        {"config": "toy_cfg", "traffic": "steady", "why": "a toy", "params": {"limits": {"same": 0.0}}}))
    (base / "traffic" / "steady.py").write_text(TOY_DRIVER)
    (base / "metrics" / "toy_metric.py").write_text(
        "def read(ctx):\n    return ctx.records[0]['toy'] if ctx.records else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_cfg", "source": "a toy", "file": "perfbench/configs/toy_cfg.json",
                             "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "toy_cfg.steady", "config": "toy_cfg", "traffic": "steady",
                               "chips": 1, "why": "a toy"})
    bench["per_layer"].append({"name": "toy_metric", "unit": "s", "better": "lower", "source": "program_span",
                               "layer": "toy", "moves": "cells_per_s", "workloads": ["toy_cfg.steady"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digest(base)
    assert all(after[k] == v for k, v in before.items()), "an existing file changed"
    assert "toy_cfg" in registry.names("configs", base)
    assert "toy_cfg.steady" in registry.names("workloads", base)
    assert "steady" in registry.names("traffic", base)
    assert "toy_metric" in registry.names("metrics", base)
    assert registry.metric("toy_metric", base) is not None
    assert registry.driver(registry.workload("toy_cfg.steady", base), base).__name__ == "Driver"
    e2e = run_cell("toy_cfg.steady", 7, 0.2, False, dev=torch.device("cpu"), base=base)
    assert e2e["correct"] and set(e2e["metrics"]) == {"cells_per_s", "setup_s"}
    traced = run_cell("toy_cfg.steady", 7, 0.2, True, dev=torch.device("cpu"), base=base)
    assert traced["metrics"]["toy_metric"]["value"] == 3.0
    # the existing cells resolve as before
    for cell in ("flagship_1p3m.device_fed", "wang_pancreas_479.repeat_calls"):
        registry.driver(registry.workload(cell, base), base)


BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_characters():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in b["paths"])
    assert len(b["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in b["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(b["paths"][0] + "/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    cfgs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["config"] in cfgs
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (BENCH / "workloads" / f"{w['name']}.json").is_file()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and (BENCH / "metrics" / f"{m['name']}.py").is_file()
    texts = [x["why"] for k in ("configs", "workloads") for x in b[k]] + [m["layer"] for m in b["per_layer"]]
    texts += [c["source"] for c in b["configs"]] + b["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


@pytest.mark.parametrize("cell", sorted({w["name"] for w in BENCHMARK["workloads"]}))
def test_every_cell_reports_enough(cell):
    e2e = registry.metrics_of(BENCHMARK, cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert registry.metrics_of(BENCHMARK, cell, "per_layer")


def test_files_are_named_from_allowed_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", str(p.relative_to(ROOT))), p
