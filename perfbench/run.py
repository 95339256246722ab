"""Runs one cell of the benchmark of `sharp_tpu_torch` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `sharp_tpu_torch`. The cell's
configuration, traffic driver and per-layer metric readers are found by
name under `perfbench/` (`lib/registry.py`). The run builds its inputs from
the seed and warms up (set-up, `setup_s`, counted from the start of the
process), then solves back to back for `--seconds`: a new solution starts
only while it can end inside the window, judged from the last one's time.
With `--trace 0` the result carries the cell's end-to-end metrics; with
`--trace 1` its per-layer metrics, from spans around the solutions of the
window and from one profiled segment after it. After the window the
program's outputs are held against the plain reference
(`perfbench/reference/`); each number compared is printed beside its limit,
as the last lines of standard error and under "checks", the last key of
the result: the JSON object on the last line of standard output.

Without a CUDA card (or with fewer than the cell asks for) the run exits 1
and prints no result; it exits 3, and prints no result, when a module of
JAX or of the JAX package is loaded in this process. Kernel and compiler
caches go to fixed directories under `build/` in the checkout; the host
libraries run `THREADS` threads.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "sharp_tpu")
# the host threads of the run's numerical libraries, fixed, so that machines
# with other numbers of cores run the same host work
THREADS = 4
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
CACHES = {
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "CUDA_CACHE_PATH": "nv_compute_cache",
}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _nvidia_smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _percentile(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs, float), q)) if xs else None


def window(drv, seconds: float, spans):
    """Solutions back to back for `seconds` -> (records, seconds, failed)."""
    records, failed = [], 0
    t0 = time.perf_counter()
    while True:
        spans.solution = len(records)
        s = time.perf_counter()
        try:
            rec = drv.solve()
        except Exception:  # a failed solution counts against `correct`
            traceback.print_exc()
            failed += 1
            break
        rec["seconds"] = time.perf_counter() - s
        records.append(rec)
        if time.perf_counter() - t0 + rec["seconds"] > seconds:
            break
    return records, time.perf_counter() - t0, failed


def end_to_end(bench, cell, records, window_s, setup_s) -> dict:
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    calls = [r["seconds"] for r in records]
    values = {
        "setup_s": setup_s,
        "cells_per_s": sum(r["cells"] for r in records) / window_s if records else None,
        "solve_p90_s": _percentile(calls, 90),
    }
    from perfbench.lib.registry import metrics_of

    out = {}
    for m in metrics_of(bench, cell, "end_to_end"):
        if values.get(m["name"]) is None:
            raise KeyError(f"end-to-end metric {m['name']!r} has no value in this run")
        out[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    return out


def profiled_segment(drv, dev):
    """The driver's profiled segment twice under torch.profiler ->
    (TraceSummary, records of the second, the second's idle share). The
    first traces the card's activity alone, which costs the host little:
    the busy time, the window and the device operations come from it. The
    second traces the host's activity too: the idle gaps by what the host
    was doing, the device time under the driver's annotations and the
    device-to-host copies come from it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.lib.trace import device_only, summarize

    card = dev.type == "cuda"
    if card:
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            drv.profile_segment()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize(dev)
        busy_s, window_s, device_ops, events = device_only(prof)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=acts) as prof:
        with record_function("perfbench.window"):
            recs = drv.profile_segment()
            if card:
                torch.cuda.synchronize(dev)
    summary = summarize(prof, annotations=drv.annotations)
    host_traced_idle = 100.0 * (1.0 - summary.busy_s / summary.window_s) if summary.window_s > 0 else None
    if card:
        summary = summary._replace(busy_s=busy_s, window_s=window_s, device_ops=device_ops, device_events=events)
    return summary, recs, host_traced_idle


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, dev=None, wl=None, cfg=None,
             base=None, control: bool = False) -> dict:
    """One run of a cell -> the result (without printing). `dev` None takes
    the card (refusing to run without one); tests pass a CPU device and
    small `wl` / `cfg` dicts."""
    from perfbench.lib import registry
    from perfbench.lib.spans import Spans

    bench = registry.benchmark(base)
    wl = wl or registry.workload(cell, base)
    cfg = cfg or registry.config(wl["config"], base)
    chips = registry.cell_entry(bench, cell)["chips"]
    import torch

    if dev is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"perfbench: cell {cell} needs {chips} CUDA card(s); "
                             f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                             f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        dev = torch.device("cuda", 0)
    import sharp_tpu_torch  # noqa: F401  (the system under test; TF32 off on import)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    spans = Spans(trace, sync)
    drv = registry.driver(wl, base)(cfg, wl.get("params", {}), int(seed), dev, spans, control=control)
    drv.setup()
    sync()
    spans.records.clear()
    setup_s = time.perf_counter() - T_START
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    records, window_s, failed = window(drv, seconds, spans)
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": chips, "memory_peak_bytes": int(max(setup_peak, window_peak)),
              "nvidia_smi": _nvidia_smi() if dev.type == "cuda" else None}
    result = {"attempted": len(records) + failed, "failed": failed}
    breakdown = None
    if not trace:
        result["metrics"] = end_to_end(bench, cell, records, window_s, setup_s)
    else:
        summary, prof_recs, host_traced_idle = profiled_segment(drv, dev)
        device["busy_s"], device["window_s"] = summary.busy_s, summary.window_s
        breakdown = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
        ctx = SimpleNamespace(records=records, window_s=window_s, spans=spans, trace=summary,
                              profiled=prof_recs, window_peak_bytes=window_peak, device=device,
                              **drv.layer_context())
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        metrics = {}
        for m in registry.metrics_of(bench, cell, "per_layer"):
            v = registry.metric(m["name"], base)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
        result["metrics"] = metrics
    drv.release()
    t_check = time.perf_counter()
    try:
        checks = drv.check(records) if records else {}
    except Exception:  # outputs the reference cannot even read are not correct
        traceback.print_exc()
        checks = {"check_raised": {"value": 1.0, "limit": 0.0, "ok": False}}
    info = drv.info(records)
    info.update(first_seconds=[r["seconds"] for r in records[:10]], check_s=time.perf_counter() - t_check,
                run_s=time.perf_counter() - T_START, threads=torch.get_num_threads())
    if trace:
        info["idle_pct_host_traced"] = host_traced_idle
    result["correct"] = bool(records) and failed == 0 and all(c["ok"] for c in checks.values())
    result["device"] = device
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["info"] = info
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    for var in THREAD_VARS:
        os.environ[var] = str(THREADS)
    import torch

    torch.set_num_threads(THREADS)
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        sys.stderr.write(f"perfbench: modules of JAX or of the JAX package are loaded: {bad}\n")
        return 3
    sys.stderr.write(f"card: {res['device'].get('nvidia_smi')}\n")
    for name, c in res["checks"].items():
        sys.stderr.write(f"check {name} = {c['value']!r} (limit {c['limit']!r})\n")
    sys.stderr.flush()
    res = {k: res[k] for k in ("correct", "attempted", "failed", "metrics", "device", "breakdown", "info", "checks")
           if k in res}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
