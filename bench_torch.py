#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: cells/s through the full clustering
pipeline on one NVIDIA card.

    python3 bench_torch.py

The port's counterpart of bench.py, with its workload, structure and
knobs. It imports torch, numpy and `sharp_tpu_torch`, nothing of JAX or of
the JAX package, and runs on the card: without one it exits 1 and prints
no metric.

Workload (`_bench_env`): 1,306,127 cells x 27,998 genes in 26 blocks (25 x
50,000 + 56,127), 38 planted types, K=5 members, p=256, folds of 2,000
cells (654 folds at n_pad 2048), with bench.py's configuration:
`resolve_config(n_cells, n_genes, ensize_K=5, reduced_ndim=256,
partition_ncells=2000, rN_seed=7, dtype_compute="bfloat16", forview=False)`
and `linkage_backend` "auto", which the port resolves per padded size (the
f32 reciprocal-NN ladder at 2048; detail.linkage_backend).

Two paths, each in a child process of its own, so each starts with the
card's memory clean:

  * the compute path (`compute_path`). Expression is generated on the card
    (bench.py's design: log-normal base, 35% DE genes at +/-6 log2 fold
    change, exp(0.3 N) noise, 20% dropout, scaled to 1e6 per cell) from
    `torch.Generator`s seeded 123 (the type means) and 999 + t (fold t).
    torch cannot reproduce JAX's threefry streams, so these draws, and the
    RP matrices (`ops.rp.ensemble_rp_matrix` from seed 7), are not the
    JAX bench's. Then: groups of SHARP_BENCH_GROUP (16) folds through the
    batched fold program (the last group padded to 16 lanes), each group
    generated and synchronised before its timed window opens and the
    window closed by one readback; the per-block sMetaC fuses in one
    batched call (`core.large.fuse_blocks`); the global sMetaC over the
    block summaries (`parallel.streaming.global_block_fuse`) on the card;
    `finalize_labels(merge_tiny=True)`. The timed total is fold pass +
    block fuse + global fuse; each fuse is timed after an untimed warm
    call. Gates: before timing, the ladder (f32 and bf16 storage at the
    fold pad) and serial Ward (at min(pad, 1024)) must give valid merge
    sequences on the card and launch their kernels, else exit 2; after,
    ARI >= SHARP_BENCH_MIN_ARI and a cluster count within
    [max(2, types // 3), ceil(1.5 types)], else exit 1.
  * the API path (`api_bench`): `sharp_unlimited` over SBLK files of the
    bench's flagship dataset (`sharp_tpu_torch.io.benchdata`), made on
    demand into a content-keyed cache (SHARP_BENCH_API_DIR, default
    ~/.cache/sharp_tpu_torch/benchdata); an untimed warm call on block 0
    declaring the timed run's n_cells, then the first
    SHARP_BENCH_API_BLOCKS (4) blocks timed, or all of them under
    SHARP_BENCH_API_FULL=1. Gates: ARI >= 0.95 on a subset under 1e6
    cells (else the compute gate) and at most ceil(1.5 types) clusters.

Output: the compute path's JSON line the moment its child returns, then
the same line with detail.api_path, last. Fields: metric
"cells_per_second_end_to_end", value, unit, vs_baseline (over the
reference's Wang pancreas rate, 479 cells in 9.771 s) and detail:
bench.py's fields, the card (`torch.cuda.get_device_name`, and its name
and power limit from nvidia-smi), min/median/max of the per-group fold
times and of the per-block fuse times (each block fused alone, untimed),
the per-block and global fuse shapes with their linkage backends, and the
kernel launches and problems (`ops.linkage_cuda.LAUNCHES`, `PROBLEMS`)
of each timed part. One deadline bounds both children
(SHARP_BENCH_TIMEOUT, default 1140 s); the API child is skipped, and
marked so, when under 240 s remain.

Env knobs (bench.py's): SHARP_BENCH_CELLS, SHARP_BENCH_BLOCK,
SHARP_BENCH_GENES, SHARP_BENCH_TYPES, SHARP_BENCH_K, SHARP_BENCH_P,
SHARP_BENCH_FOLD, SHARP_BENCH_MIN_ARI, SHARP_BENCH_QUICK=1 (65,536 cells,
one block), SHARP_BENCH_GROUP, SHARP_BENCH_STAGES=0 (skip the per-stage
breakdown), SHARP_BENCH_PROFILE=<dir> (a torch.profiler trace of the
timed fold pass), SHARP_BENCH_API=0 (skip the API path),
SHARP_BENCH_API_NNZ, SHARP_BENCH_API_DIR, SHARP_BENCH_API_BLOCKS,
SHARP_BENCH_API_FULL, SHARP_BENCH_TIMEOUT.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# the reference's Wang pancreas rate (cells/s), README.md:97-103
BASELINE_CELLS_PER_S = 479 / 9.771


def _bench_env():
    """Shared workload parameters (compute + API children must agree)."""
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


def bench_config(env):
    """bench.py's configuration of the workload `env`."""
    from sharp_tpu_torch.config import resolve_config

    return resolve_config(
        env["n_cells"], env["n_genes"], ensize_K=env["K"], reduced_ndim=env["p"],
        partition_ncells=env["fold"], rN_seed=7, dtype_compute="bfloat16", forview=False,
    )


def fold_plan(blocks, partition_ncells):
    """(block id, fold size) of every fold, in global fold order."""
    from sharp_tpu_torch.core.large import fold_sizes

    return [(bi, sz) for bi, bn in enumerate(blocks) for sz in fold_sizes(bn, partition_ncells)]


def quality_gates(tag, s, k, n_types, min_ari):
    """ARI floor + cluster-count drift bound (two independent gates: a
    run can over-cluster with a fine-looking ARI, or the reverse)."""
    msgs = []
    if s < min_ari:
        msgs.append(f"{tag}: ARI {s:.4f} < {min_ari}")
    k_hi = int(np.ceil(1.5 * n_types))
    k_lo = max(2, n_types // 3)
    if k > k_hi:
        msgs.append(f"{tag}: {k} clusters found > 1.5x the {n_types} planted")
    if k < k_lo:
        msgs.append(f"{tag}: {k} clusters found < {k_lo} (over-merged from {n_types} planted)")
    return msgs


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


def spread(xs):
    """min / median / max of a list of seconds."""
    return dict(min=float(np.min(xs)), median=float(np.median(xs)), max=float(np.max(xs)), n=len(xs))


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


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def counts():
    """A copy of the kernels' launch and problem counters."""
    from sharp_tpu_torch.ops import linkage_cuda

    return dict(linkage_cuda.LAUNCHES), dict(linkage_cuda.PROBLEMS)


def since(before):
    """The launches and problems counted since `before` (`counts()`)."""
    return tuple({k: n - b[k] for k, n in now.items()} for now, b in zip(counts(), before))


# --- the compute path ----------------------------------------------------------


def parity_precheck(dev, B):
    """Structural validation of the linkage backends on `dev` before any
    timing (bench.py:110-154): the ladder in f32 and bf16 storage at the
    fold pad B, and serial Ward at min(B, 1024), on 12 planted centroids
    (numpy seed 11, 48 pad rows), each merge sequence through
    `validate_merge_sequence`. On a card, the kernels must have run: the
    round kernel (B > 256, the tail's size), the tail kernel twice and
    serial Ward. Returns (the backend "auto" resolves to at B, problems,
    launches)."""
    import torch

    from sharp_tpu_torch.ops.distance import pearson_distance
    from sharp_tpu_torch.ops.linkage import resolve_linkage_backend, validate_merge_sequence, ward_linkage_rnn
    from sharp_tpu_torch.ops.linkage_cuda import ward_linkage_serial

    def make_D(n_pad):
        rng = np.random.default_rng(11)
        n_real = n_pad - 48
        types = rng.integers(0, 12, n_real)
        cents = rng.normal(size=(12, 64)) * 3.0
        X = np.zeros((n_pad, 64), np.float32)
        X[:n_real] = cents[types] + rng.normal(size=(n_real, 64))
        mask = np.arange(n_pad) < n_real
        return pearson_distance(torch.from_numpy(X).to(dev), torch.from_numpy(mask).to(dev)), n_real

    before = counts()
    problems = {}
    D, n_real = make_D(B)
    for tag, st in (("rnn_f32", None), ("rnn_bf16", torch.bfloat16)):
        res = ward_linkage_rnn(D, store_dtype=st)
        errs = validate_merge_sequence(res.merges, res.heights, n_real, B)
        if errs:
            problems[tag] = errs
    Bp = min(B, 1024)
    Dp, n_real_p = (D, n_real) if Bp == B else make_D(Bp)
    res = ward_linkage_serial(Dp.contiguous())
    errs = validate_merge_sequence(res.merges, res.heights, n_real_p, Bp)
    if errs:
        problems["serial_f32"] = errs
    launches, _ = since(before)
    if dev.type == "cuda":
        need = {"rnn_tail": 2, "ward_serial": 1, "rnn_round": 1 if B > 256 else 0}
        missing = [k for k, n in need.items() if launches[k] < n]
        if missing:
            problems["kernels"] = [f"not launched: {missing} (launches {launches})"]
    return resolve_linkage_backend("auto", B), problems, launches


def card_generator(n_genes, n_types, B, dev):
    """bench.py's on-device expression (:216-246) with torch generators:
    type means from seed 123 (log-normal base, 35% DE genes, signs +/-1,
    lfc 6), fold t from seed 999 + t (uniform types, exp(0.3 N) noise, 20%
    dropout, each cell scaled to 1e6). Returns make_group(t0, sizes) ->
    (X (G, B, genes) float32, planted types (G, B)) for folds t0..t0+G-1;
    like bench.py's, every lane is B cells, its pad rows masked later."""
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


def _group_masks(sizes, B, dev):
    import torch

    return torch.arange(B, device=dev)[None, :] < torch.tensor(sizes, device=dev)[:, None]


def fold_pass(make_group, plan, B, R_all, cfg, group, dev, n_blocks):
    """The fold pass (bench.py:326-401): groups of `group` folds of `plan`
    through the batched fold program, the last group padded to `group`
    lanes with its first fold's size. make_group(t0, sizes) -> (X (G, B,
    genes), planted types (G, B)) on dev; each group is made and
    synchronised before its timed window opens, and the window closes on
    one readback. Summaries and types are pulled after the window.
    Returns a dict: block_frs (per block, its folds' host summaries),
    truth (per fold, its planted types), group_seconds, gen_seconds and
    per group its kernel launches and problems."""
    from sharp_tpu_torch.core.fold import fold_program, fold_static_args
    from sharp_tpu_torch.core.large import summaries_to_host

    static = fold_static_args(cfg)
    block_frs = [[] for _ in range(n_blocks)]
    truth, seconds, launches, problems = [], [], [], []
    gen_s = 0.0
    for g0 in range(0, len(plan), group):
        gplan = plan[g0 : g0 + group]
        sizes = [sz for _, sz in gplan]
        lane_sizes = sizes + [sizes[0]] * (group - len(sizes))
        t = time.perf_counter()
        Xg, ys = make_group(g0, lane_sizes)
        masks = _group_masks(lane_sizes, B, dev)
        _sync(dev)
        gen_s += time.perf_counter() - t
        before = counts()
        t0 = time.perf_counter()
        out = fold_program(Xg, masks, lane_sizes, R_all, True, None, **static)
        out.n_meta.cpu()  # the fold program's last outputs: the window closes here
        seconds.append(time.perf_counter() - t0)
        lc, pc = since(before)
        launches.append(lc)
        problems.append(pc)
        del Xg, masks
        frs = summaries_to_host(out, sizes + [0] * (group - len(sizes)), False)
        ys = ys.cpu().numpy()
        del out
        for gi, (bi, sz) in enumerate(gplan):
            truth.append(ys[gi, :sz])
            block_frs[bi].append(frs[gi])
    return dict(block_frs=block_frs, truth=truth, group_seconds=seconds, gen_seconds=gen_s,
                launches=launches, problems=problems)


def block_fuse(block_frs, cfg, dev):
    """The per-block sMetaC fuses in one batched call (bench.py:404-418),
    every block of a shape bucket in one `smetac` call (`group`), ->
    (fused, block summaries (centroids, counts) of each block's live
    clusters, each block's labels as positions in them)."""
    from sharp_tpu_torch.core.large import fuse_blocks

    fused = fuse_blocks(block_frs, cfg, group=len(block_frs), device=dev)
    summaries, labels = [], []
    for fres in fused:
        uniq = np.unique(fres.labels)
        summaries.append((fres.cents[uniq], fres.counts[uniq]))
        labels.append(np.searchsorted(uniq, fres.labels))
    return fused, summaries, labels


def global_fuse(summaries, block_labels, cfg, dev):
    """The global sMetaC over the block summaries and the final labels
    (bench.py:420-445); one block's consensus is the final clustering."""
    from sharp_tpu_torch.parallel.streaming import global_block_fuse
    from sharp_tpu_torch.types import finalize_labels

    if len(summaries) == 1:
        return finalize_labels(block_labels[0].astype(np.int32), merge_tiny=True)
    tf, remap, offsets, _, _ = global_block_fuse(summaries, cfg, dev)
    parts = [remap[tf[offsets[bi] + block_labels[bi]]] for bi in range(len(summaries))]
    return finalize_labels(np.concatenate(parts).astype(np.int32), merge_tiny=True)


def _timed_ms(fn, dev, r=3):
    """Mean ms of r calls of fn after a warm call: CUDA events on a card,
    the host clock around synchronised calls elsewhere."""
    import torch

    fn()
    _sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(r):
            fn()
        return (time.perf_counter() - t0) * 1e3 / r
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(r):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / r


def stage_breakdown(Xg, masks, lane_sizes, R_all, cfg, dev):
    """The fold program's stages on one group (bench.py:283-325), each the
    mean of 3 runs: the RP product of the group's folds, their Pearson
    distances, the linkage of the G*K lanes, and the whole fold program.
    The intermediates are released before returning."""
    import torch

    from sharp_tpu_torch.core.fold import fold_program, fold_static_args
    from sharp_tpu_torch.ops.distance import pearson_distance
    from sharp_tpu_torch.ops.linkage import resolve_linkage_backend
    from sharp_tpu_torch.ops.rp import rp_project_ensemble
    from sharp_tpu_torch.ops.select import linkage

    static = fold_static_args(cfg)
    K = static["K"]
    G, B, genes = Xg.shape
    lane_mask = masks.repeat_interleave(K, dim=0)
    backend = resolve_linkage_backend(static["linkage_backend"], B, static["hmethod"])

    def rp():
        return rp_project_ensemble(torch.log2(1.0 + Xg).reshape(G * B, genes), R_all, K=K)

    proj = rp().reshape(K, G, B, -1).transpose(0, 1).reshape(G * K, B, -1)
    D = pearson_distance(proj, lane_mask).contiguous()
    out = dict(
        rp_project_s=_timed_ms(rp, dev) / 1e3,
        distance_s=_timed_ms(lambda: pearson_distance(proj, lane_mask), dev) / 1e3,
        linkage_s=_timed_ms(lambda: linkage(D, backend, static["hmethod"]), dev) / 1e3,
        fold_program_total_s=_timed_ms(
            lambda: fold_program(Xg, masks, lane_sizes, R_all, True, None, **static), dev) / 1e3,
        per_group_folds=G,
        linkage=backend,
    )
    del proj, D
    return out


def _fuse_shapes(block_frs, summaries, cfg):
    """The padded size and linkage backend of each per-block fuse (blocks
    per NC_pad) and of the global fuse."""
    from sharp_tpu_torch.config import pad_dim
    from sharp_tpu_torch.core.large import _prepare_block
    from sharp_tpu_torch.ops.linkage import resolve_linkage_backend

    per_block = {}
    for frs in block_frs:
        if len(frs) == 1:
            continue
        prep = _prepare_block(frs, cfg)
        row = per_block.setdefault(str(prep.NC_pad), dict(
            blocks=0, clusters=[], linkage=resolve_linkage_backend(cfg.linkage_backend, prep.NC_pad, cfg.hmethod)))
        row["blocks"] += 1
        row["clusters"].append(prep.NC)
    NC = sum(len(c) for _, c in summaries)
    NC_pad = pad_dim(max(NC, 8))
    return per_block, dict(clusters=NC, nc_pad=NC_pad, linkage=resolve_linkage_backend("auto", NC_pad))


def compute_path(env, dev, stages=True, group=16, profile_dir=None):
    """bench.py's compute path (:157-509) on `dev`. Returns (the JSON
    line, gate messages, exit code: 0, 1 for a failed gate, 2 for a failed
    parity pre-check, and a record of what the line leaves out: per fold
    group its seconds, launches and problems, and the launches of each
    timed part)."""
    import torch

    from sharp_tpu_torch.analysis.ari import ari
    from sharp_tpu_torch.config import pad_dim
    from sharp_tpu_torch.core.fold import fold_program, fold_static_args
    from sharp_tpu_torch.core.large import fuse_folds
    from sharp_tpu_torch.ops.rp import ensemble_rp_matrix

    n_cells, n_genes, n_types = env["n_cells"], env["n_genes"], env["n_types"]
    K, p, min_ari, blocks = env["K"], env["p"], env["min_ari"], env["blocks"]
    cfg = bench_config(env)
    plan = fold_plan(blocks, cfg.partition_ncells)
    T = len(plan)
    B = pad_dim(max(sz for _, sz in plan))
    card = dict(device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
                nvidia_smi=nvidia_smi() if dev.type == "cuda" else None)

    # --- parity pre-check (refuse to publish invalid numbers) -------------
    backend, problems, pre_launches = parity_precheck(dev, B)
    if problems:
        line = {
            "metric": "cells_per_second_end_to_end", "value": 0.0, "unit": "cells/s", "vs_baseline": 0.0,
            "detail": {"error": "linkage parity pre-check FAILED on device", "problems": problems,
                       "backend": dev.type, **card},
        }
        return line, [f"parity pre-check: {problems}"], 2, {}

    make_group = card_generator(n_genes, n_types, B, dev)
    R_all = ensemble_rp_matrix(7, K, n_genes, p, dtype=torch.bfloat16, device=dev)
    group = min(group, T)
    static = fold_static_args(cfg)

    # --- warm-up (the kernels' build, the CUDA context) ---------------------
    sizes0 = [sz for _, sz in plan[:group]]
    sizes0 += [sizes0[0]] * (group - len(sizes0))
    Xg, _ = make_group(0, sizes0)
    ms = _group_masks(sizes0, B, dev)
    t0 = time.perf_counter()
    fold_program(Xg, ms, sizes0, R_all, True, None, **static).n_meta.cpu()
    compile_s = time.perf_counter() - t0
    stage_s = stage_breakdown(Xg, ms, sizes0, R_all, cfg, dev) if stages else {}
    # released to the allocator's cache, which the timed groups reuse
    del Xg, ms

    # --- timed run ------------------------------------------------------------
    trace = contextlib.nullcontext()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        trace = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else []))
    before = counts()
    with trace:
        fp = fold_pass(make_group, plan, B, R_all, cfg, group, dev, len(blocks))
    fold_launches = since(before)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        trace.export_chrome_trace(os.path.join(profile_dir, "bench_torch_fold_pass.json"))
    fold_pass_s = float(np.sum(fp["group_seconds"]))
    block_frs = fp["block_frs"]
    # everything downstream works on host summaries
    del make_group, R_all
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    block_fuse(block_frs, cfg, dev)  # warm every shape bucket
    compile_s += time.perf_counter() - t0
    before = counts()
    t0 = time.perf_counter()
    _, summaries, block_labels = block_fuse(block_frs, cfg, dev)
    block_fuse_s = time.perf_counter() - t0
    fuse_launches = since(before)

    t0 = time.perf_counter()
    global_fuse(summaries, block_labels, cfg, dev)  # warm
    compile_s += time.perf_counter() - t0
    before = counts()
    t0 = time.perf_counter()
    labels = global_fuse(summaries, block_labels, cfg, dev)
    global_fuse_s = time.perf_counter() - t0
    global_launches = since(before)

    # untimed: each block's fuse alone, for the spread of per-block times
    each = []
    for frs in block_frs:
        t0 = time.perf_counter()
        fuse_folds(frs, cfg, device=dev)
        each.append(time.perf_counter() - t0)

    total_s = fold_pass_s + block_fuse_s + global_fuse_s
    truth = np.concatenate(fp["truth"])
    score = float(ari(truth, labels))
    n_final = int(len(np.unique(labels)))
    gate_msgs = quality_gates("compute", score, n_final, n_types, min_ari)
    per_block, glob = _fuse_shapes(block_frs, summaries, cfg)
    parts = {"fold_pass": fold_launches, "block_fuse": fuse_launches, "global_fuse": global_launches}
    cells_per_s = n_cells / total_s
    line = {
        "metric": "cells_per_second_end_to_end",
        "value": cells_per_s,
        "unit": "cells/s",
        "vs_baseline": cells_per_s / BASELINE_CELLS_PER_S,
        "detail": {
            "n_cells": n_cells,
            "n_genes": n_genes,
            "n_blocks": len(blocks),
            "n_folds": T,
            "n_planted_types": n_types,
            "ensemble_K": K,
            "reduced_dim": p,
            "ari_vs_planted_types": score,
            "ari_gate_min": min_ari,
            "ari_gate_passed": not gate_msgs,
            "n_clusters_found": n_final,
            "linkage_backend": backend,
            "fold_pass_seconds": fold_pass_s,
            "block_fuse_seconds": block_fuse_s,
            "global_fuse_seconds": global_fuse_s,
            "total_seconds": total_s,
            "datagen_seconds_untimed": fp["gen_seconds"],
            "compile_seconds": compile_s,
            "backend": dev.type,
            **card,
            "fold_group_size": group,
            "fold_group_seconds": spread(fp["group_seconds"]),
            "block_fuse_each_seconds_untimed": spread(each),
            "block_fuses": per_block,
            "global_fuse": glob,
            "launches": {k: v[0] for k, v in parts.items()},
            "problems": {k: v[1] for k, v in parts.items()},
            "precheck_launches": pre_launches,
            **({"stages": stage_s} if stage_s else {}),
        },
    }
    record = dict(group_seconds=fp["group_seconds"], group_launches=fp["launches"],
                  group_problems=fp["problems"], block_fuse_each_seconds=each)
    return line, gate_msgs, (1 if gate_msgs else 0), record


def main_compute():
    dev = _card()
    env = _bench_env()
    line, msgs, rc, _ = compute_path(
        env, dev, stages=os.environ.get("SHARP_BENCH_STAGES", "1") == "1",
        group=int(os.environ.get("SHARP_BENCH_GROUP", 16)),
        profile_dir=os.environ.get("SHARP_BENCH_PROFILE"),
    )
    print(json.dumps(line), flush=True)
    if msgs:
        sys.stderr.write(("QUALITY GATE FAILED: " if rc == 1 else "") + "; ".join(msgs) + "\n")
    sys.exit(rc)


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
    """The API-path child, in a process of its own so that its card memory
    starts clean."""
    dev = _card()
    env = _bench_env()
    sub = None if os.environ.get("SHARP_BENCH_API_FULL") == "1" else int(
        os.environ.get("SHARP_BENCH_API_BLOCKS", 4))
    detail, msgs = api_bench(
        env["blocks"], env["n_genes"], env["n_types"], env["K"], env["p"],
        env["fold"], env["min_ari"], dev, sub_blocks=sub,
    )
    detail["gate_passed"] = not msgs
    print(json.dumps({"api_path": detail}), flush=True)
    if msgs:
        sys.stderr.write("QUALITY GATE FAILED: " + "; ".join(msgs) + "\n")
        sys.exit(1)


# --- the parent process ----------------------------------------------------------


def _run_child(flag, deadline):
    """Run one bench child within `deadline` (a time.time() value) ->
    (its last JSON line or None, exit code, stderr tail)."""
    remaining = deadline - time.time()
    if remaining < 60:
        return None, -1, "no budget left"
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), flag],
            timeout=remaining, capture_output=True, text=True,
        )
    except subprocess.TimeoutExpired:
        return None, -1, f"timed out after {remaining:.0f} s"
    sys.stderr.write(proc.stderr[-4000:])
    obj = None
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                pass
    return obj, proc.returncode, proc.stderr[-2000:] or f"rc={proc.returncode}, no JSON"


def _parent_main():
    """Run the compute and API children under one deadline
    (SHARP_BENCH_TIMEOUT s, default 1140): the compute line is printed the
    moment its child returns, the merged line (with detail.api_path) last.
    A genuine API gate failure (a JSON line and rc != 0) fails the run; a
    child that dies, or a remainder under 240 s, is recorded in
    detail.api_path."""
    _card()
    total = int(os.environ.get("SHARP_BENCH_TIMEOUT", 1140))
    deadline = time.time() + total
    obj, rc, err = _run_child("--compute", deadline - 30)
    if obj is None:
        print(json.dumps({
            "metric": "cells_per_second_end_to_end", "value": 0.0, "unit": "cells/s", "vs_baseline": 0.0,
            "detail": {"error": f"compute bench failed: {err[-500:]}"},
        }), flush=True)
        return 1
    print(json.dumps(obj), flush=True)

    final_rc = rc
    detail = obj.setdefault("detail", {})
    if os.environ.get("SHARP_BENCH_API", "1") == "1":
        remaining = deadline - time.time() - 45
        if remaining < 240:
            detail["api_path"] = {
                "skipped": f"only {remaining:.0f}s of the {total}s budget remain after the compute path"
            }
        else:
            aobj, arc, aerr = _run_child("--api", time.time() + remaining)
            if aobj is not None and "api_path" in aobj:
                ap = aobj["api_path"]
                if detail.get("total_seconds") and detail.get("n_cells"):
                    ap["cells_per_s_vs_compute"] = ap["cells_per_s"] / (detail["n_cells"] / detail["total_seconds"])
                detail["api_path"] = ap
                final_rc = final_rc or arc
            else:
                detail["api_path"] = {"error": f"api child failed: {(aerr or '')[-500:]}"}
    print(json.dumps(obj), flush=True)
    return final_rc


if __name__ == "__main__":
    if "--compute" in sys.argv:
        main_compute()
    elif "--api" in sys.argv:
        main_api()
    else:
        sys.exit(_parent_main())
