"""Finds the benchmark's parts by name: configurations, cells (workloads),
traffic drivers and per-layer metric readers, each in a file of its own
under the benchmark's folder, so that a new one is a new file and an entry
in BENCHMARK.json and no existing file changes.

  configs/<config>.json        sizes, knobs, source, reduced, assumed
  workloads/<cell>.json        config, traffic, params, limits
  traffic/<traffic>.py         class Driver: setup(), solve(), check(), layer_context()
  metrics/<metric>.py          read(ctx) -> number or None
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]


def root(base: Path = None) -> Path:
    return Path(base) if base is not None else HERE


def benchmark(base: Path = None) -> dict:
    """BENCHMARK.json at the root of the checkout that holds the folder."""
    with open(root(base).parent / "BENCHMARK.json") as fh:
        return json.load(fh)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise KeyError(f"no such file: {path}")
    with open(path) as fh:
        return json.load(fh)


def config(name: str, base: Path = None) -> dict:
    return _json(root(base) / "configs" / f"{name}.json")


def workload(name: str, base: Path = None) -> dict:
    wl = _json(root(base) / "workloads" / f"{name}.json")
    wl.setdefault("name", name)
    return wl


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise KeyError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(wl: dict, base: Path = None):
    """The traffic driver class of a cell: traffic/<traffic>.py."""
    return _module(root(base) / "traffic" / f"{wl['traffic']}.py", f"perfbench_traffic_{wl['traffic']}").Driver


def metric(name: str, base: Path = None):
    """The reader of a per-layer metric: read(ctx) -> number or None."""
    return _module(root(base) / "metrics" / f"{name}.py", f"perfbench_metric_{name}").read


def names(kind: str, base: Path = None) -> List[str]:
    """The names of one kind of part present in the folder."""
    sub = {"configs": "*.json", "workloads": "*.json", "traffic": "*.py", "metrics": "*.py"}[kind]
    return sorted(p.stem for p in (root(base) / kind).glob(sub) if not p.stem.startswith("_"))


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"cell {cell!r} is not in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, kind: str) -> List[Dict]:
    """The end-to-end or per-layer metrics that `cell` reports. A per-layer
    metric without a `workloads` list goes with every cell that reports
    the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]
