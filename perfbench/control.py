"""The control of `correct`: the program run in the precision just below
the one its configuration states, through the same window and check.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 --seconds 5

The cell's traffic driver switches the program's own lower-precision path
on (`control=True`): the RP operands in float8 where the configuration
states bfloat16, the program's float32 products in TF32 where it states
float32 with TF32 off. Each seed prints one JSON line with the numbers
compared and their limits; a sound control reads `correct` false. The
benchmark's own runs never run it; `tests/test_perfbench_reference.py`
runs it on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell: str, seeds, seconds: float):
    """One control run a seed -> [{seed, correct, checks}, ...]."""
    from perfbench.run import CACHES, run_cell

    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    out = []
    for seed in seeds:
        res = run_cell(cell, seed, seconds, False, control=True)
        out.append({"seed": seed, "correct": res["correct"], "checks": res["checks"],
                    "rule_chain": res["info"].get("rule_chain")})
    return out


def main(argv=None) -> int:
    from perfbench.run import forbidden_modules

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    for rec in readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds):
        print(json.dumps(rec), flush=True)
    if forbidden_modules():
        sys.stderr.write(f"control: modules of JAX or of the JAX package are loaded: {forbidden_modules()}\n")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
