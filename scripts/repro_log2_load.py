#!/usr/bin/env python3
"""Reproduce the first-call fault of torch.log2 on the CPU under load.

    python3 scripts/repro_log2_load.py [--procs 160] [--streams 4] [--busy 4]
                                       [--warm]

Starts `--procs` fresh Python processes, `--streams` at a time, beside
`--busy` processes that keep the cores busy with numpy products. Each fresh
process takes its first torch.log2 of a float32 tensor on 102,400 values
of 1 + x (x lognormal, seed 0) over torch's threads, and counts the values
more than 1 ulp from float64's log2 of the same float32 sums. With `--warm`
the process goes through `sharp_tpu_torch.ops.rp.log2p1`, whose first call
of a process is on one element; without it, through torch.log2 itself.

Prints each faulty process's count, worst error in ulps and the first and
last position that went wrong (a fault on one thread's whole chunk shows as
one contiguous run), then one JSON line of the totals. Without load, or on
another MKL, the fault may not show at all: no fault in a run is not proof
of the cause.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
x = torch.from_numpy(np.random.default_rng(0).lognormal(1, 1, 102400).astype(np.float32))
if sys.argv[2] == "warm":
    from sharp_tpu_torch.ops.rp import log2p1
    got = log2p1(x).numpy()
else:
    got = torch.log2(1.0 + x).numpy()
s = (np.float32(1.0) + x.numpy()).astype(np.float64)
exact = np.log2(s)
ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
err = np.abs(got - exact) / ulp
far = np.flatnonzero(err > 1)
print(json.dumps({"far": int(far.size), "worst": float(err.max()),
                  "first": int(far[0]) if far.size else None, "last": int(far[-1]) if far.size else None}))
"""

_BUSY = """
import numpy as np
a = np.random.default_rng(0).random((1500, 1500))
while True:
    a = a @ a.T
    a /= np.abs(a).max()
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=160)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--busy", type=int, default=4)
    ap.add_argument("--warm", action="store_true")
    args = ap.parse_args()
    mode = "warm" if args.warm else "cold"
    busy = [subprocess.Popen([sys.executable, "-c", _BUSY]) for _ in range(args.busy)]

    def one(_):
        out = subprocess.run([sys.executable, "-c", _CHILD, ROOT, mode], capture_output=True, text=True,
                             check=True, timeout=300)
        return json.loads(out.stdout)

    try:
        with ThreadPoolExecutor(args.streams) as pool:
            results = list(pool.map(one, range(args.procs)))
    finally:
        for p in busy:
            p.kill()
            p.wait()
    bad = [r for r in results if r["far"]]
    for r in bad:
        print(f"[log2] {r['far']} values off, worst {r['worst']:.0f} ulps, positions {r['first']}-{r['last']}")
    print(json.dumps({"mode": mode, "procs": args.procs, "faulty": len(bad),
                      "worst_ulps": max((r["worst"] for r in results), default=0.0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
