#!/usr/bin/env python3
"""Where serial Ward spends a merge, on the card: clock cycles per phase.

    python3 scripts/profile_ward_serial.py

Builds `sharp_tpu_torch/csrc/ward_serial.cu` with -DWARD_PROFILE into
build/kernels/profile/ and runs it through `ward_linkage_serial` on the
serial Ward shapes of chip_smoke.py (wMetaC-like, padded, tied, random), in
f32 and bf16 storage. Thread 0 of the first problem adds the cycles of each
phase of every merge: the pop, the pick of (i, j), the fresh row with the
cache updates (up to its barrier), row i's minimum, and the rescans (up to
the merge's last barrier), and counts the rescans. Prints cycles per merge
per phase and rescans per merge, and writes chiprun_out/ward_serial_profile.json.
The counters cost a few percent of the kernel's time, so time the kernel
with chip_smoke.py, not with this build.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import chip_smoke as cs  # noqa: E402
from sharp_tpu_torch.config import resolve_config  # noqa: E402
from sharp_tpu_torch.ops import _build  # noqa: E402
from sharp_tpu_torch.ops import linkage_cuda  # noqa: E402

PHASES = ("pop", "pick", "fresh_row", "row_i", "rescans")


def _build_profiled():
    out_dir = os.path.join(ROOT, "build", "kernels", "profile")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libward_serial_profile.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DWARD_PROFILE", "-o", out,
           str(_build.CSRC / "ward_serial.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    for name, (restype, argtypes) in _build._SIGNATURES["ward_serial.cu"].items():
        getattr(lib, name).restype = restype
        getattr(lib, name).argtypes = argtypes
    lib.sharp_ward_profile.restype = ctypes.c_int
    lib.sharp_ward_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def _problems(dev):
    """chip_smoke.py's serial Ward shapes; the wMetaC problems from planted
    labels drawn here (10 types over a 2,000-cell fold, 7 over 479 cells)."""
    fold_cfg = resolve_config(50000, 27998, **cs.SEED_KW)
    small_cfg = resolve_config(479, 20000, **cs.SEED_KW)
    return {
        "wmetac_fold_1x256": cs._wmetac_problem(
            dev, fold_cfg, np.random.default_rng(5).integers(0, 10, 2000), 2048, seed=2)[0],
        "random_2x200": cs._random_problem(dev, 2, 200, 190, seed=4),
        "random_2x257": cs._random_problem(dev, 2, 257, 250, seed=5),
        "random_15x512": cs._random_problem(dev, 15, 512, 479, seed=1),
        "wmetac_1x640": cs._wmetac_problem(
            dev, small_cfg, np.random.default_rng(1).integers(0, 7, 479), 512, seed=0)[0],
        "random_1x1024": cs._random_problem(dev, 1, 1024, 1000, seed=2),
        "smetac_1x1024": cs._smetac_like_problem(dev, 1024, 1000, seed=3),
        "random_1x2048": cs._random_problem(dev, 1, 2048, 2000, seed=6),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_ward_serial: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lib = _build_profiled()
    real = _build.load_kernels
    _build.load_kernels = lambda: {"ward_serial.cu": lib}
    buf = (ctypes.c_ulonglong * 8)()
    rows = {}
    try:
        for name, D in _problems(dev).items():
            n = D.shape[-1]
            for st_name, st in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                if n == 2048 and st_name == "f32":
                    continue
                linkage_cuda.ward_linkage_serial(D, store_dtype=st)   # warm-up
                torch.cuda.synchronize()
                lib.sharp_ward_profile(ctypes.addressof(buf), 1)
                linkage_cuda.ward_linkage_serial(D, store_dtype=st)
                torch.cuda.synchronize()
                if lib.sharp_ward_profile(ctypes.addressof(buf), 1) != 0:
                    raise RuntimeError("reading the profile counters failed")
                c = list(buf)
                row = {p: c[k] / (n - 1) for k, p in enumerate(PHASES)}
                row["total"] = sum(row[p] for p in PHASES)
                row["rescans_per_merge"] = c[5] / (n - 1)
                rows[f"{name} {st_name}"] = row
                print(f"{name:18s} {st_name:4s} cycles per merge: "
                      + " | ".join(f"{p} {row[p]:.0f}" for p in PHASES)
                      + f" | total {row['total']:.0f}; rescans per merge {row['rescans_per_merge']:.2f}",
                      flush=True)
    finally:
        _build.load_kernels = real
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ward_serial_profile.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "cycles_per_merge": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
