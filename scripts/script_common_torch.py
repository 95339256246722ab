"""What the port's tuning and profiling scripts (`scripts/*_torch.py`) share:
the device (a CUDA request without a card raises), times closed by a
synchronise, the check that nothing of JAX was loaded, and the record's
JSON line beside the card's name and power limit (`bench_torch`'s
`nvidia_smi`; its `counts` and `since` count the kernels' launches).
Imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench_torch  # noqa: E402


def parser(doc):
    """The scripts' argument parser: --device (default cuda)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default; raises without a card) or cpu (the kernels' plain versions)")
    return ap


def device(name):
    """torch.device(name), checked: a CUDA request without a card raises."""
    import torch

    from sharp_tpu_torch.api import resolve_device

    dev = resolve_device(name)
    return torch.device("cuda", 0) if dev.type == "cuda" else dev


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev, reps=3, warm=1):
    """fn's seconds: `warm` calls first, then `reps` calls, each on the host
    clock and closed by a synchronise. Returns (median, every rep, the last
    call's result)."""
    out = None
    for _ in range(warm):
        out = fn()
    sync(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts, out


def check_modules():
    """Raise if anything of JAX or of the JAX package was loaded."""
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sharp_tpu"))
    if loaded:
        raise AssertionError(f"loaded modules of JAX or of the JAX package: {loaded[:10]}")


def launches_since(before):
    """The kernels' launches since `before` (`bench_torch.counts()`), those
    that launched."""
    return {k: n for k, n in bench_torch.since(before)[0].items() if n}


def finish(name, record, dev):
    """Check the modules, print the card's line (on the card) and the record
    as one JSON line, and write it to chiprun_out/<name>.json."""
    check_modules()
    record["device"] = str(dev)
    if dev.type == "cuda":
        import torch

        record["nvidia_smi"] = bench_torch.nvidia_smi()
        record["device_name"] = torch.cuda.get_device_name(0)
        print(record["nvidia_smi"], flush=True)
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{name}.json"), "w") as fh:
        json.dump(record, fh, indent=1)
    print(json.dumps(record), flush=True)
