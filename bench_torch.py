#!/usr/bin/env python3
"""The API path of the PyTorch/CUDA port on one NVIDIA card:
`sharp_unlimited` over the SBLK blocks of the flagship dataset.

    python3 bench_torch.py

It imports torch, numpy and `sharp_tpu_torch`, nothing of JAX or of the
JAX package, and runs on the card: without one it exits 1 and prints no
metric. The port's benchmark is `perfbench/` (`BENCHMARK.json`); its cell
`flagship_1p3m.device_fed` times the whole 1,306,127-cell solution fed from
the card. This script times what a caller of `sharp_unlimited` waits for
on the same atlas read from files.

Workload (`_bench_env`): 1,306,127 cells x 27,998 genes in 26 blocks (25 x
50,000 + 56,127), 38 planted types, K=5 members, p=256, folds of 2,000
cells, bf16 RP, forview off. The blocks (`sharp_tpu_torch.io.benchdata`,
2,048 nonzero genes a cell) are made on demand into a content-keyed cache
(SHARP_BENCH_API_DIR, default ~/.cache/sharp_tpu_torch/benchdata); an
untimed warm call on block 0 declares the timed run's n_cells, then the
first SHARP_BENCH_API_BLOCKS (4) blocks are timed, or all of them under
SHARP_BENCH_API_FULL=1. Gates: ARI >= 0.95 on a subset under 1e6 cells
(else SHARP_BENCH_MIN_ARI) and at most ceil(1.5 types) clusters; a failed
gate exits 1.

Output: one JSON line {"api_path": {...}}: cells/s, the timed seconds, ARI
against the planted types, the cluster count, the stage seconds, the
kernels' launches and problems (`ops.linkage_cuda.LAUNCHES`, `PROBLEMS`)
and the card (`torch.cuda.get_device_name`, and its name and power limit
from nvidia-smi).

Env knobs: SHARP_BENCH_CELLS, SHARP_BENCH_BLOCK, SHARP_BENCH_GENES,
SHARP_BENCH_TYPES, SHARP_BENCH_K, SHARP_BENCH_P, SHARP_BENCH_FOLD,
SHARP_BENCH_MIN_ARI, SHARP_BENCH_QUICK=1 (65,536 cells, one block),
SHARP_BENCH_API_NNZ, SHARP_BENCH_API_DIR, SHARP_BENCH_API_BLOCKS,
SHARP_BENCH_API_FULL.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def _bench_env():
    """The workload's parameters, from the SHARP_BENCH_* variables."""
    quick = os.environ.get("SHARP_BENCH_QUICK") == "1"
    n_cells = int(
        os.environ.get("SHARP_BENCH_CELLS", 65536 if quick else 1306127)
    )
    n_genes = int(os.environ.get("SHARP_BENCH_GENES", 27998))
    default_types = 12 if n_cells < 1e6 else 38
    n_types = int(os.environ.get("SHARP_BENCH_TYPES", default_types))
    K = int(os.environ.get("SHARP_BENCH_K", 5))
    p = int(os.environ.get("SHARP_BENCH_P", 256))
    fold = int(os.environ.get("SHARP_BENCH_FOLD", 2000))
    block_cells = int(os.environ.get("SHARP_BENCH_BLOCK", 50000))
    min_ari = float(
        os.environ.get(
            "SHARP_BENCH_MIN_ARI", 0.95 if n_cells < 1e6 else 0.80
        )
    )
    # block partition (reference: 25 x 50,000 + 56,127, README.md:289)
    blocks = []
    left = n_cells
    while left > 0:
        take = block_cells if left >= 2 * block_cells else left
        blocks.append(take)
        left -= take
    return dict(
        n_cells=n_cells, n_genes=n_genes, n_types=n_types, K=K, p=p,
        fold=fold, min_ari=min_ari, blocks=blocks,
    )


def api_gates(s, k, n_types, min_ari, subset, n_cells):
    """The API path's gates -> (messages, the ARI floor applied). A subset
    under 1e6 cells does not trip smetac_range's widened floor that the
    relaxed full-scale floor allows for, so it is held to 0.95."""
    if subset and n_cells < 1e6:
        min_ari = max(min_ari, 0.95)
    msgs = []
    if s < min_ari:
        msgs.append(f"api: ARI {s:.4f} < {min_ari}")
    if k > int(np.ceil(1.5 * n_types)):
        msgs.append(f"api: {k} clusters found > 1.5x the {n_types} planted")
    return msgs, min_ari


def nvidia_smi():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _card():
    """cuda:0, or exit 1 (no metric) without a card."""
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("bench_torch: torch.cuda.is_available() is False; no CUDA device to run on\n")
        sys.exit(1)
    return torch.device("cuda", 0)


def counts():
    """A copy of the kernels' launch and problem counters."""
    from sharp_tpu_torch.ops import linkage_cuda

    return dict(linkage_cuda.LAUNCHES), dict(linkage_cuda.PROBLEMS)


def since(before):
    """The launches and problems counted since `before` (`counts()`)."""
    return tuple({k: n - b[k] for k, n in now.items()} for now, b in zip(counts(), before))


def card_generator(n_genes, n_types, B, dev):
    """bench.py's on-device expression (:216-246) with torch generators:
    type means from seed 123 (log-normal base, 35% DE genes, signs +/-1,
    lfc 6), fold t from seed 999 + t (uniform types, exp(0.3 N) noise, 20%
    dropout, each cell scaled to 1e6). Returns make_group(t0, sizes) ->
    (X (G, B, genes) float32, planted types (G, B)) for folds t0..t0+G-1;
    like bench.py's, every lane is B cells, its pad rows masked later. The
    tuning and profiling scripts (`scripts/*_torch.py`) make their data
    with it."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(123)
    base = torch.exp(1.0 + torch.randn(n_genes, generator=g, device=dev))
    de_mask = torch.rand(n_genes, generator=g, device=dev) < 0.35
    signs = torch.randint(0, 2, (n_types, n_genes), generator=g, device=dev).float() * 2.0 - 1.0
    type_means = base[None, :] * torch.where(de_mask[None, :], 2.0 ** (signs * 6.0), 1.0)

    def gen_fold(t, out):
        gf = torch.Generator(device=dev)
        gf.manual_seed(999 + t)
        y = torch.randint(0, n_types, (B,), generator=gf, device=dev)
        X = torch.exp(0.3 * torch.randn((B, n_genes), generator=gf, device=dev))
        X *= torch.rand((B, n_genes), generator=gf, device=dev) > 0.2
        X *= type_means[y]
        torch.mul(X, 1e6 / torch.clamp_min(X.sum(dim=1, keepdim=True), 1e-9), out=out)
        return y

    def make_group(t0, sizes):
        Xg = torch.empty((len(sizes), B, n_genes), dtype=torch.float32, device=dev)
        ys = torch.stack([gen_fold(t0 + gi, Xg[gi]) for gi in range(len(sizes))])
        return Xg, ys

    return make_group


# --- the API path ----------------------------------------------------------------


def api_bench(blocks, n_genes, n_types, K, p, fold, min_ari, dev, sub_blocks=None):
    """Time the shipped `sharp_unlimited` over SBLK blocks (bench.py:574-696).

    The dataset's blocks are made on demand into their cache directory
    (`io.benchdata`; a subset run makes only its own blocks). The timed
    region is the streaming stack: SBLK read and prefetch thread, CSR
    triplets to the card and the densify there, the fold pass, the batched
    block fuses, manifest writes, the global sMetaC and the relabel. An
    untimed warm call on block 0 declares the timed run's n_cells (the
    declared size drives smetac_range's search width). `sub_blocks` runs
    the first S blocks (reported with extrapolated_full_seconds), None all.
    Returns (detail, gate messages).
    """
    import shutil
    import tempfile

    from sharp_tpu_torch import sharp_unlimited
    from sharp_tpu_torch.analysis.ari import ari
    from sharp_tpu_torch.io import benchdata

    G = n_genes
    keep = int(os.environ.get("SHARP_BENCH_API_NNZ", 2048))
    keep = min(keep, (G * 4) // 5)  # tiny-G configs stay sparse
    full_cells = sum(blocks)
    S = len(blocks) if sub_blocks is None else min(sub_blocks, len(blocks))
    run_blocks = blocks[:S]
    n_cells = sum(run_blocks)
    ddir = benchdata.dataset_dir(full_cells, G, n_types, keep)
    datagen_s = benchdata.make_blocks(ddir, run_blocks, G, n_types, keep)
    y = np.concatenate([benchdata.block_y(bi, bn, n_types) for bi, bn in enumerate(run_blocks)])

    api_kw = dict(
        rN_seed=7, ensize_K=K, reduced_ndim=p, partition_ncells=fold,
        dtype_compute="bfloat16", forview=False, resume=False, device=dev,
    )
    warm_dir = tempfile.mkdtemp(prefix="sharp_bench_apiwarm_")
    run_dir = tempfile.mkdtemp(prefix="sharp_bench_apirun_")
    mdir = tempfile.mkdtemp(prefix="sharp_bench_manifest_")
    try:
        os.symlink(os.path.join(ddir, "block_00000.sblk"), os.path.join(warm_dir, "block_00000.sblk"))
        for bi in range(S):
            name = f"block_{bi:05d}.sblk"
            os.symlink(os.path.join(ddir, name), os.path.join(run_dir, name))
        with open(os.path.join(run_dir, "blocks.json"), "w") as fh:
            json.dump({"n_cells": n_cells, "n_genes": G, "n_blocks": S}, fh)
        t0 = time.time()
        sharp_unlimited(warm_dir, n_cells=n_cells, manifest_dir=None, **api_kw)
        compile_s = time.time() - t0
        before = counts()
        t0 = time.time()
        res = sharp_unlimited(run_dir, manifest_dir=mdir, **api_kw)
        api_s = time.time() - t0
        launches, problems = since(before)
    finally:
        shutil.rmtree(mdir, ignore_errors=True)
        shutil.rmtree(warm_dir, ignore_errors=True)
        shutil.rmtree(run_dir, ignore_errors=True)

    api_ari = float(ari(y, res.pred_clusters))
    k = int(res.N_pred_cluster)
    msgs, floor = api_gates(api_ari, k, n_types, min_ari, S < len(blocks), n_cells)
    detail = {
        "cells_per_s": n_cells / api_s,
        "total_seconds": api_s,
        "measured_blocks": S,
        "total_blocks": len(blocks),
        "measured_cells": int(n_cells),
        "extrapolated": S < len(blocks),
        "ari_vs_planted_types": api_ari,
        "ari_gate_min": floor,
        "n_clusters_found": k,
        "nnz_per_cell": keep,
        "datagen_seconds_untimed": datagen_s,
        "warm_compile_seconds_untimed": compile_s,
        "timing": {r["stage"]: r["seconds"] for r in (res.timing or {}).get("stages", [])},
        "launches": launches,
        "problems": problems,
    }
    if S < len(blocks):
        detail["extrapolated_full_seconds"] = api_s * full_cells / n_cells
    return detail, msgs


def main_api():
    """Run the API path on cuda:0 and print its line."""
    import torch

    dev = _card()
    env = _bench_env()
    sub = None if os.environ.get("SHARP_BENCH_API_FULL") == "1" else int(
        os.environ.get("SHARP_BENCH_API_BLOCKS", 4))
    detail, msgs = api_bench(
        env["blocks"], env["n_genes"], env["n_types"], env["K"], env["p"],
        env["fold"], env["min_ari"], dev, sub_blocks=sub,
    )
    detail.update(gate_passed=not msgs, device=torch.cuda.get_device_name(dev), nvidia_smi=nvidia_smi())
    print(json.dumps({"api_path": detail}), flush=True)
    if msgs:
        sys.stderr.write("QUALITY GATE FAILED: " + "; ".join(msgs) + "\n")
        sys.exit(1)


if __name__ == "__main__":
    main_api()
