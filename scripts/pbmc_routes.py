"""The pbmc4k cell's sample through the port's routes, each held to the
plain reference.

    python3 scripts/pbmc_routes.py card SEED[,SEED...] [--umi JSON] [--cfg JSON]
    python3 scripts/pbmc_routes.py cpu SEED[,SEED...] [--umi JSON] [--cfg JSON]

For each seed the cell `pbmc4k_4340.count_calls` is set up as the
benchmark sets it up (`perfbench/traffic/count_calls.py`: the UMI sample,
the RP matrices and the testlog's draws from the seed, on the card) and
`sharp()` runs at the cell's knobs through two routes:

  card: the cell's own route (the f32 ladder at n_pad 4608) and serial Ward
        on the card, for the members' linkage;
  cpu:  the cell's own route, and the whole call on the host's CPU (the
        plain ladder rounds, cut replay and sweep).

Each answer is held to `perfbench/reference/small.py`, as the cell's check
holds it (label_gap, k_gap, maxsil_err, viE_err), and the routes to each
other. In card mode also: the largest gap between the port's member
distances and the reference's, and the first merge at which the trees
part, per member: serial Ward against the reference's greedy Ward on the
reference's distances, the ladder against serial Ward, and the
reference's greedy Ward on the port's own distances against serial Ward.
One JSON line a seed on stdout.

`--umi` overrides the generator's parameters, for instance a sample with
next to no recoverable types: '{"marker_pool": 16000, "markers": 337,
"marker_lfc": [1.5, 4.0]}' (markers over 2% of the detectable genes);
`--cfg` overrides keys of the configuration (small sizes for the CPU);
`--device cpu` sets the traffic up on the CPU. Imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from perfbench.lib import registry  # noqa: E402
from perfbench.lib.spans import Spans  # noqa: E402
from perfbench.reference import cluster, small  # noqa: E402
from perfbench.reference.compare import label_gap, rel_err  # noqa: E402

import sharp_tpu_torch  # noqa: E402
import sharp_tpu_torch.core.block as block  # noqa: E402
from sharp_tpu_torch.core.pipeline import TestlogProbe  # noqa: E402

CELL = "pbmc4k_4340.count_calls"


def _answer(res) -> dict:
    return {"labels": res.pred_clusters, "k_per": res.per_member_k, "maxsil": res.per_member_maxsil,
            "viE": res.viE}


def _against(a: dict, b: dict) -> dict:
    return {"label_gap": label_gap(a["labels"], b["labels"]), "k_gap": float(np.abs(a["k_per"] - b["k_per"]).max()),
            "maxsil_err": float(np.abs(a["maxsil"] - b["maxsil"]).max()), "viE_err": rel_err(a["viE"], b["viE"])}


def _first_diff(a: torch.Tensor, b: torch.Tensor) -> list:
    """Per problem, the first merge at which two merge sequences part; -1
    where they are equal."""
    d = (a.long() != b.long()).any(dim=-1)
    return [int(x.float().argmax()) if bool(x.any()) else -1 for x in d]


def routes(seed: int, mode: str, dev: torch.device, umi: dict = None, cfg: dict = None) -> dict:
    """One seed through the routes of `mode` ("card" or "cpu") -> record."""
    wl = registry.workload(CELL)
    c = registry.config(wl["config"])
    c = {**c, "umi": {**c["umi"], **(umi or {})}, **(cfg or {})}
    n = c["n_cells"]
    drv = registry.driver(wl)(c, {**wl["params"], "warm_calls": 1}, seed, dev, Spans(False))
    drv.setup()
    cap = {}
    link = block.linkage

    def capture(name, force=None):
        def lk(D, backend, hmethod):
            if D.shape[-1] < n:                   # the testlog's probe
                return link(D, backend, hmethod)
            out = link(D, force or backend, hmethod)
            cap[name] = (D[:, :n, :n].clone() if force else None, out.merges[:, : n - 1])
            return out
        return lk

    answers = {}
    try:
        block.linkage = capture("cell")
        answers["cell"] = _answer(drv._call())
        if mode == "card":
            block.linkage = capture("serial", "serial")
            answers["serial"] = _answer(drv._call())
        else:
            block.linkage = link
            cpu = torch.device("cpu")
            answers["cpu"] = _answer(sharp_tpu_torch.sharp(
                drv.X, rM=drv.R.to(cpu), testlog_probe=TestlogProbe(drv.probe.perm.to(cpu), drv.probe.R.to(cpu)),
                device="cpu", ensize_K=c["ensize_K"], reduced_ndim=c["reduced_ndim"], exp_type=c["exp_type"],
                linkage_backend=c["linkage_backend"], rN_seed=7))
    finally:
        block.linkage = link
    out = {"seed": seed, "mode": mode, "umi": umi or {}}
    with cluster.full_float32():
        for name, a in answers.items():
            ref = drv.reference(prefer={"k_per": a["k_per"], "labels": a["labels"]})
            ref_answer = {"labels": ref.labels, "k_per": ref.k_per, "maxsil": np.asarray(ref.maxsil), "viE": ref.viE}
            out[name] = _against(a, ref_answer)
            out["reference_log"] = ref.log
        names = list(answers)
        out["routes"] = {f"{x}_vs_{y}": _against(answers[x], answers[y])
                         for i, x in enumerate(names) for y in names[i + 1:]}
        out["gap_to_planted"] = label_gap(answers["cell"]["labels"], drv.truth)
        if mode == "card":
            D_port, serial = cap["serial"]
            X = small.preprocess(torch.as_tensor(drv.X, device=dev), c["exp_type"])
            D_ref = cluster.pearson_distance(cluster.project(X, drv.R.float(), c["ensize_K"], out["reference_log"],
                                                             "float32"))
            out["distance_gap"] = float((D_port - D_ref).abs().max())
            greedy_ref, _ = cluster.ward(D_ref)
            greedy_port, _ = cluster.ward(D_port)
            out["first_parting_merge"] = {
                "serial_vs_reference": _first_diff(serial, greedy_ref),
                "cell_vs_serial": _first_diff(cap["cell"][1], serial),
                "greedy_on_port_distances_vs_serial": _first_diff(greedy_port, serial),
            }
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("card", "cpu"))
    ap.add_argument("seeds", help="comma-separated seeds")
    ap.add_argument("--umi", default="{}", help="JSON: generator parameters to override")
    ap.add_argument("--cfg", default="{}", help="JSON: configuration keys to override")
    ap.add_argument("--device", default="cuda", help="the device the traffic is set up on")
    ap.add_argument("--threads", type=int, default=4, help="host threads")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for s in args.seeds.split(","):
        rec = routes(int(s), args.mode, torch.device(args.device), json.loads(args.umi), json.loads(args.cfg))
        print(json.dumps(rec), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
