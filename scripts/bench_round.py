#!/usr/bin/env python3
"""Time one ladder round and the whole ladder on the card.

    python3 scripts/bench_round.py [--tag NAME]

Card only (exits 1 without one). The data: the first fold group of a
flagship-like block (tests/synth.py, 32,000 cells x 5,000 genes, 10 planted
types, data seed 0; 16 folds x K=5 members of p=391 at n_pad 2048), and two
pad-heavy groups cut from the same cells: the bench's last fold group (14
folds of 2,000 cells, two of 1,063 and 1,064) and one whose two short folds
hold 40 cells. chip_smoke.py's helpers do the work: every round of each
group's ladder is held against the plain round (`_capture_rounds`).

  1. One round alone, f32 and bf16, at (80, 2048) and (80, 1024): the first
     round of the level, and a pad round (round 60 of the level, when only
     the 10 lanes of the two short folds are live, one pair each), through
     `_hold_round`: the median CUDA-event time of the round kernel's
     wrapper from the saved state (restored, L2 flushed), the plain
     round's, the kernels alone (torch.profiler), and the bound from the
     bytes the round needs (`round_bytes`) over 3.35 TB/s.
  2. The ladder's rounds on the bench's last fold group and on the first
     fold group (`rnn_ladder`, synchronised, median of 3): ms, rounds
     launched, ms a round, host reads (`RnnLadder.host_reads`).

Prints one line a measurement and the record as JSON last; writes it to
chiprun_out/bench_round_<tag>.json.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_CFG = types.SimpleNamespace(ensize_K=5, reduced_ndim=391)
PAD_ROUND = 60


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_round: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import chip_smoke as cs
    from synth import make_tpm_like

    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.ops.linkage import rnn_ladder

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[bench_round] {args.tag}: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    X, _ = make_tpm_like(n_cells=cs.FOLD * cs.GROUP, n_genes=5000, n_types=10, seed=0)
    short = (cs.FOLD,) * (cs.GROUP - 2)
    groups = (
        ("first", None, None, ((2048, 1), (1024, 1))),
        ("pad_1063", short + (1063, 1064), (1024, PAD_ROUND), ((1024, PAD_ROUND),)),
        ("pad_40", short + (40, 40), (2048, PAD_ROUND), ((2048, PAD_ROUND),)),
    )
    rec = {"tag": args.tag, "device": smi, "rounds": {}, "ladders": {}}
    for store_name, store in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for group, sizes, keep, want in groups:
            D, _ = cs._fold_group_distances(X, dev, sizes, GROUP_CFG)
            ladder, saved, _, held = cs._capture_rounds(D, store, keep)
            del ladder
            for m, t in want:
                name = f"{store_name} m={m} {'first' if t == 1 else 'pad'}"
                row = cs._hold_round(f"rnn_round {args.tag} {name}", saved[m if t == 1 else (m, t)])
                row.update(group=group, round=t, rounds_held=held)
                rec["rounds"][name] = row   # its device times are filled in at the end
            del saved
            if group != "pad_40":
                walls = []
                for _ in range(3):
                    before = linkage_cuda.LAUNCHES["rnn_round"]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ladder = rnn_ladder(D, store_dtype=store)
                    torch.cuda.synchronize()
                    walls.append(1e3 * (time.perf_counter() - t0))
                    launched = linkage_cuda.LAUNCHES["rnn_round"] - before
                real = int(sum(int(r) for r in ladder.level_rounds))
                wall = float(np.median(walls))
                rec["ladders"][f"{store_name} {group}"] = dict(
                    ms=wall, walls_ms=walls, rounds=launched, rounds_real=real, ms_per_round=wall / launched,
                    host_reads=ladder.host_reads)
                print(f"[bench_round] {args.tag} ladder {store_name} {group}: {wall:.1f} ms (of {walls}), "
                      f"{launched} rounds launched ({real} with a lane active), {wall / launched:.4f} ms a round, "
                      f"{ladder.host_reads} host reads", flush=True)
                del ladder
            del D
            torch.cuda.empty_cache()
    for row, key, fn, kernel, label in cs._DEFERRED:
        row[key] = cs._device_ms(fn, kernel) or cs._device_ms(fn, kernel)
        print(f"[bench_round] {label}: {key} {row[key]} ms on the card alone", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"bench_round_{args.tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
