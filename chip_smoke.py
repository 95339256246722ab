#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sharp_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. build    nvcc builds the hand-written kernels (csrc/*.cu: serial Ward,
              the cut replay, the ladder's tail and its round, the RP
              operand, the selection sweep) into build/kernels/, one nvcc
              per source, all at once.
  2. data     the flagship block: 50,000 cells x 27,998 genes, 10 planted
              types (tests/synth.py, data seed 0), made once on the host.
  3. kernels  each kernel against its plain PyTorch version on the card.
              First the RP product at a fold group's shape (16 x 2,048 rows
              of the flagship block, 27,998 genes, K=5 x p=256 in bf16): the
              operand kernel identical to log2p1(X).to(bf16) with zero pad
              columns, the tensor-core product within 1e-6 norm-wise of the
              float64 product of the same operands; the operand kernel
              timed beside its bound (bytes over 3.35 TB/s) and its plain
              version, the product beside its bound (bf16 operations over
              989 TFLOP/s) and today's float32 torch.matmul of the same
              operands (library_ms), the whole stage beside the float32
              stage it replaces, and each one's device kernels.
              Serial Ward in f32 and in bf16 storage (merges and heights
              identical) at (K=15, n=512, 479 real) from Pearson distances
              of projected data, at (1, 640) from a wMetaC-like similarity,
              at (1, 1024, 1000 real), at (1, 1024) on tied sMetaC-like
              centroids (near-duplicate replicas, half exact copies), at
              (2, 200) and (2, 257) on both sides of its shared-memory tier,
              in bf16 at (1, 2048), and in f32 at (1, 8320), above n 8192
              where its row state moves to a global scratch (one call, the
              plain loop timed once); the cut replay on the f32 merges.
              Serial Ward is timed per shape (ms and microseconds per
              merge). Large-tier shapes, from the
              first fold group of the flagship block (G=16 folds x K=5
              members of 2,000 cells at n_pad 2048), in f32 and in bf16
              storage: every round of the ladder through the round kernel
              against the plain round on a copy of the ladder (matrix, row
              cache, cluster and merge state identical), and the first round
              at levels 2048 and 1024 timed from its saved state, its bound
              counted from what the round needs (`round_bytes`: rows a and
              b of the real pairs and the rows whose cached minimum grew
              read, the changed entries written) and by the earlier
              kernel's count (all of W read and written); the bench's
              last fold group (14 folds of 2,000 cells, 2 of 1,063 and
              1,064, whose pads merge one pair a round): every round held
              the same way, the whole ladder's merges and heights identical
              to plain rounds, its time, rounds launched and with a lane
              active, host reads, and round 60 of level 1024 (10 of 80 lanes
              live, one pair each) timed; the ladder tail at (80, 256) on the survivor state
              the ladder compacts the group down to; the whole ladder with
              kernel rounds against the same rounds finished by the plain
              tail and against plain rounds (round_impl="xla"), merges and
              heights identical, and both timed in turns (xla, pallas,
              pallas, xla); the cut replay at (80, 2048); the selection
              sweep's three kernels at (80, 2048) on its cuts against the
              plain sweep (msil identical, CH within 1e-5 relative), timed
              beside it and beside their bound, and alone on the profiler
              there (its 1.3 GB of inputs are not kept to the run's end);
              serial Ward (both
              storage types) and the cut replay on the wMetaC problem (1,
              256) and on a fold group's 16 wMetaC problems (16, 256), the
              shape wMetaC gives them now. Median times from CUDA events
              (kernels 20 calls, plain versions 3), and each kernel's
              bound: its bytes over 3.35 TB/s or its float32 operations over
              67 TFLOP/s, whichever is larger. The cut replay's launch floor:
              the same kernel on a two-cell problem. The route each tail lane
              and each cut-replay problem took (ROUTES). At the very end of
              the run, after every wall is taken, the kernels are timed
              again alone on the card with torch.profiler (device_ms),
              without the host's share of a call.
  4. slice    the small tier: sharp_tpu_torch.sharp(X, rN_seed=2103,
              exp_type="TPM", device="cuda") at (a) 479 cells x 20,000
              genes, 7 planted types, (b) 1,000 x 20,000, (a) with
              linkage_backend="pallas_bf16" (serial Ward in bf16 storage),
              and (g) 4,500 x 5,000, 10 types, padded to 4608 (the ladder,
              and a cut replay above the old kernel's cap of 4096): ARI >=
              0.9, every linkage and cut replay went through the kernels,
              and at (a) in both backends and at (g) the card and the CPU
              agree with the same numpy-made draws. The cut replay at
              (15, 4608) on (g)'s block merges against the plain replay.
  5. large    the large tier. (a) 6,000 x 5,000 (3 folds at n_pad 2048,
              testlog active) on the card and on the CPU with the same
              numpy-made RP matrices, testlog probe and cell reshuffle:
              labels, per-member cluster counts and folds identical; this
              run also warms the card up. (b) The flagship block, 25 folds:
              ARI >= 0.9 against the planted types; every fold group's block
              linkage ran its rounds in the round kernel (3 levels) and its
              tail in the tail kernel; serial Ward took every fold's wMetaC
              problem and sMetaC's (ops.linkage_cuda.PROBLEMS) in at most one
              wMetaC launch per fold group and one sMetaC launch; a cut
              replay per linkage; each selection through the sweep's three
              kernels, once each; and in each fold-program call the round
              kernel at each ladder level (2048, 1024, 512) and no other,
              the tail kernel once and serial Ward once, on the group's
              wMetaC problems (one a lane). Then the same block with
              linkage_backend="rnn_bf16", one more f32 run with the parts of
              fold_ensemble synchronised and timed (the group's selection,
              one select_cut, and its wMetaC among them), and one under
              torch.profiler counting the call's host reads.
  6. unlimited  sharp_unlimited over SBLK files written into a temporary
              directory outside the checkout (removed at the end). (a) 3
              blocks of 2,500 x 5,000 with one injected numpy RP matrix:
              labels identical on the card and on the CPU, and with the
              sparse feed and the host densify. (b) The first 4 blocks of
              the bench's flagship dataset (50,000 x 27,998 each, 38 planted
              types, 2,048 nonzero genes per cell, 3.3 GB of SBLK), called as
              the bench's API path calls it after an untimed warm-up on
              block 0: ARI >= 0.95, at most 57 clusters, the round kernel 3
              times and the tail kernel once per fold group, serial Ward on
              every fold's wMetaC problem in at most one launch per fold
              group (and at most one per block and one more for the fuses), a
              cut replay per linkage, no cut-replay problem on the serial
              route; wall and stage seconds; then, as in phase 5 (b), a run
              with the parts timed and one counting the host reads.
  7. analysis  run after phase 5, before phase 6, on the flagship block and
              the labels, x0 and viE of phase 5 (b)'s sharp() run. (a)
              gethclust on a Pearson d of log2 expression and its features
              at 479 and 1,000 cells x 20,000 genes (n_pad 512, 1024): serial
              Ward and the cut replay launched; f, height and the chosen cut
              identical to the CPU, msil within 1e-6 and CH within 1e-4
              relative. (b) Marker genes: on a 4,096 x 2,048 cut dp, best and
              auc identical to the CPU, z and fc within 1e-5 relative; on the
              whole block the call twice identical, four row blocks = the
              full matrix, every cluster keeps a marker, and
              get_marker_genes_unlimited2 over four gene slices with ng=1
              selects get_marker_genes' genes at its thresholds; the call's
              wall, and the host's column slicing, the copies to the card and
              the card's statistics timed apart. (c) The embedding: a 10,000-
              cell subsample, PCA to 50, 500 t-SNE iterations: finite,
              between-cluster distance > 3 x within-cluster spread; the card
              and the CPU within 1e-2 of the layout after 10 iterations from
              one start layout at n 500; the call's wall, the host's input,
              the joint P and the loop timed apart. (d) python -m
              sharp_tpu_torch cluster, markers and embed in subprocesses
              with the default device on 479 x 20,000: ARI >= 0.9, the JAX
              CLI's npz keys. (e) gethclust at 8,300 points (n_pad 8704,
              above the old cap of 8192): its serial Ward linkage identical
              to the plain loop on the same padded matrix; one call timed.
  8. parallel  folds and members over two shards, both on this card, and two
              processes. Run after phase 7 ((a), (b)) and after phase 6 (b)
              ((c), before its directory is removed). (a) Phase 5 (a)'s input
              and draws with n_devices=2, and with n_devices=2,
              ensemble_axis=2, ensize_K=4 (against ensize_K=4 on one
              device): labels, per-member counts and folds identical to one
              device, on the card and on the CPU. (b) The flagship block with
              n_devices=2: labels identical to phase 5 (b)'s, ARI >= 0.9; its
              wall beside phase 5 (b)'s. In (a) and (b), on each shard
              (ops.linkage_cuda.SHARD_LAUNCHES) the round kernel at every
              ladder level and the tail kernel once per group, a cut replay
              per linkage and, on each data shard's first device, serial Ward
              on every fold's wMetaC problem in at most one launch per fold
              group (SHARD_PROBLEMS). (c) Two processes of the CLI's
              `unlimited <phase 6 (b)'s directory> --multihost --no-resume`
              with phase 6 (b)'s knobs (torch.distributed over gloo on a free
              localhost port), each printing its launch counts after the
              command: process 0's labels, then process 1's, equal phase 6
              (b)'s; both report its cluster count; ARI >= 0.95 with at most
              57 clusters; each process launched every kernel its two blocks'
              folds need, as in (a) and (b), with its fuses besides.
  9. none     (the number of the bench's compute path, which is gone: the
              benchmark's cell flagship_1p3m.device_fed runs that solution)
 10. surface  the JAX package's knobs and entry points beside the main
              path. (a), (b), (d) right after phase 5 (b); (c) after phase 8 (c).
              (a) The flagship block through sharp() under
              SHARP_TPU_FOLD_TIMING=1 and a SHARP_TPU_HBM_BUDGET that makes
              auto_group pick a group of 4 (7 fold groups): labels identical
              to phase 5 (b)'s at group 16, every kernel launched (3 ladder
              levels and a tail a group, serial Ward on every wMetaC problem,
              a cut replay per linkage); prints the group and the
              [fold-timing] parts (slice, transfer, device, readback) and
              their sum beside fold_ensemble. (b) fuse_folds(frs, cfg, N) on
              the card with the JAX package's positional arguments, on (a)'s
              fold summaries: the labels and cluster count of fuse_folds(frs,
              cfg). (c) The SBLK codec (g++, io/native) on phase 6 (b)'s first
              block, 50,000 x 27,998: built and loaded; densify on 1 thread
              and on all threads identical to the numpy plain version; the
              three times. (d) The JAX package's jit-compiled entry points,
              each call's launches counted apart from the comparisons: (i)
              ward_linkage_fast and ward_linkage_deferred on (a)'s block
              distance (15, 512), (b)'s (15, 1024) and phase 3's tied (1,
              1024): one serial Ward launch a call, merges and heights
              identical to ward_linkage_serial and the plain loop, ms a call,
              the kernel alone and the plain loop's time; (ii)
              ward_linkage_deferred for each other monotone method on lane 0
              of (a): no launch, identical to the plain loop on the CPU; (iii)
              ward_linkage_rnn with tail "xla" and "auto" on the flagship
              block's first fold group (80, 2048), f32 and bf16: identical,
              the tail kernel launched 0 and 1 times; (iv) opt_hclust on that
              group with precomputed_link: labels, k and maxsil of the call
              without it, no linkage launch, one cut replay; (v) fold_program
              on its 16 folds (16, 2048): indN_cluster=6 without has_indN
              gives indN_cluster=None's result, with has_indN=True every
              member's k is 6.
 11. multihost26  scripts/multihost_26block_torch.py's configurations, after
              phase 10 (c), through the script's functions: two processes on
              this card (gloo on a free localhost port, LOCAL_WORLD_SIZE=2),
              13 of the 26 SBLK blocks each. (a) Mechanics: 26 x 2,000 cells x 400
              genes, n_cells declared 1,306,127 (the widened cluster range
              and all-gather budget): the processes agree on the cluster
              count, 26 manifests of one fingerprint, a resume run from them
              that runs no fold pass, launches nothing outside the global
              fuse and gives the cold labels, and one process's labels equal
              the two's. (b) Quality: 26 x 2,000 cells, 8 types at 600
              genes, K=8, p=128: ARI >= 0.9, one process = two. (c) The
              flagship: the bench's 26 SBLK blocks (1,306,127 x 27,998, made
              where missing into io.benchdata's cache, about 21 GB, and
              kept) with its API path's knobs: the checks of (a), ARI >=
              0.80 with at most 57 clusters, and every kernel launched in
              each process's cold run. Prints the cold, resume and
              one-process walls, each worker's seconds and summary_gather.
 12. scripts  the six scripts/*_torch.py counterparts of the JAX side's
              tuning and profiling programs, after phase 11, at the JAX
              scripts' sizes through their functions and gates, each one's
              launches counted: tune_linkage_rnn_torch (the ladder's grid of
              pair_cap 128/256/512 x compact_n 256/512 x compact_cap 32/64
              on (20, 2048) in bf16 storage: every lane's merges valid, both
              compact_cap values identical; the replica's rounds per level
              beside the port's), bench_linkage_backends_torch (the ladder
              and serial Ward in f32 and bf16 at (5, 2048) and (5, 1024):
              every sequence valid, serial f32's real merges the f32
              ladder's up to the order of exactly tied heights),
              profile_fold_torch (a group of 4 x 2,048 x 27,998 through the
              fold program with "rnn" and "rnn_bf16"), profile_fuse_batched_
              torch (sMetaC at NC_pad 1024 and 1536, G 1 and one call of G
              8: each block of the batch equal to its fuse alone),
              profile_fuse_torch (fuse_folds on 6 fake blocks of 25 folds:
              cold = warm, smetac replayed = warm) and
              debug_bench_quality_torch (6 folds of the 65,536-cell bench
              configuration and their fuse; its DUMP keys). Then the kernel
              shapes those grids reach, against the plain versions: every
              round of the ladder over the grid's batch at pair_cap 256 and
              512 (P 512 in f32 takes the scatter's 32-row strip), f32 and
              bf16, the first round at 2048 timed with its bound
              (`round_bytes`), the whole ladder with kernel rounds = plain
              rounds; the tail at (20, 512), past the shared-memory tier
              (every lane on the rows route); serial Ward at (1, 2048) on the
              backends' data in f32 and bf16.

The last line of standard output is {"ok": true, "device": {...}}; the line
before it holds the card's name and power limit as nvidia-smi prints them,
and the one before that the kernels' JSON record: per kernel its launches
in the run of phase 6 (b) and the problems they took (and, under
launches_by_path, its launches in the flagship run of phase 5 (b), in
phase 7 (a)'s gethclust calls, in phase 8 (b), the flagship block over two
shards, in phase 10 (a), in phase 10 (d)'s entry-point calls, by
configuration and process in phase 11's cold runs and by script in phase
12; and under wide_shapes its phase 12 shapes), its largest difference
from the plain version, its time per call (and device_ms, the kernel
alone), the plain version's, its bound and what bounds it. The ladder
round's wrapper launches two kernels, each listed: rnn_pairs (the pairs'
selection and fresh rows) and rnn_round (the scatter and the next row
cache); their plain version is the plain round.
No single PyTorch call
computes any of the linkage kernels' functions, so their library_ms is
null; the RP operand's entry carries the float32 torch.matmul of the same
operands as library_ms, and the tensor-core product and the whole stage
beside it. The full record
goes to chiprun_out/chip_smoke.json. Without a CUDA device the script exits
1 and prints no result; it imports nothing of JAX or of the JAX package and
fails if either is loaded.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_REPS = 20
PLAIN_REPS = 3
# the H100 SXM's memory rate and float32 rate outside the tensor cores
# (NVIDIA's data sheet), for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# the tensor cores' dense bf16 rate (NVIDIA's data sheet), for the RP
# product's bound, and the atlas's ensemble (K members of width p)
BF16_FLOPS = 989e12
RP_K, RP_P = 5, 256
SEED_KW = dict(rN_seed=2103, exp_type="TPM")
FLAGSHIP = dict(n_cells=50000, n_genes=27998, n_types=10, seed=0)
FOLD, GROUP = 2000, 16
# the small tier's shapes (name, cells, genes, planted types, linkage
# backend): (a), (b), (a) again with serial Ward in bf16 storage, and (g)
# padded to 4608: the ladder, and a cut replay above the old kernel's cap
SLICE_SHAPES = (
    ("wang_479x20000", 479, 20000, 7, "auto"),
    ("cells_1000x20000", 1000, 20000, 7, "auto"),
    ("wang_479x20000_pallas_bf16", 479, 20000, 7, "pallas_bf16"),
    ("cells_4500x5000", 4500, 5000, 10, "auto"),
)


def _median_ms(fn, reps):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_ms(fn, kernel, reps=KERNEL_REPS):
    """The kernel's own time on the card (CUPTI, through torch.profiler): the
    mean duration of the device kernels whose name holds `kernel` over
    `reps` calls of fn, without the host's share of a call; for a tuple of
    names (kernels that fn launches once each), the sum of each kernel's
    mean. None where the profiler saw no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    total, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for ev in prof.key_averages():
        for name in names:
            if name in ev.key:
                total[name] += getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
                count[name] += ev.count
    if not all(count[name] and total[name] > 0 for name in names):
        return None
    return sum(total[name] / count[name] for name in names) / 1e3


# the kernels' own times, taken after every wall of the run (see main)
_DEFERRED = []


def _device_ms_later(row, key, fn, kernel, label):
    """Queue `_device_ms(fn, kernel)` into row[key]: the profiler runs at the
    end, after every wall of the run is taken."""
    row[key] = None
    _DEFERRED.append((row, key, fn, kernel, label))


def _ternary(rng, m, p):
    """Numpy draw of an (m, p) ternary very-sparse RP matrix (R/ranM.R:17-24)."""
    s = np.sqrt(np.float32(m))
    u = rng.random((m, p), dtype=np.float32)
    t = 1.0 / (2.0 * s)
    return np.where(u < t, np.sqrt(s), np.where(u > 1.0 - t, -np.sqrt(s), 0.0)).astype(np.float32)


def _wmetac_like_labels(y, K, nc_pad, rng):
    """K member labellings of planted types y: each member splits two random
    types in half and relabels its clusters in a random order, as RP
    members of a clean data set do."""
    n = len(y)
    labels = np.empty((n, K), np.int32)
    for k in range(K):
        lab = y.copy()
        nxt = lab.max() + 1
        for t in rng.choice(lab.max() + 1, 2, replace=False):
            idx = np.nonzero(lab == t)[0]
            lab[rng.choice(idx, len(idx) // 2, replace=False)] = nxt
            nxt += 1
        perm = rng.permutation(nxt)
        labels[:, k] = perm[lab]
    assert labels.max() < nc_pad - 1
    return labels


def _wmetac_problem(dev, cfg, ys, n_pad, seed):
    """The wMetaC meta problems of G = len(ys) folds of len(y) cells padded
    to n_pad: distances of the similarity of K member labellings of the
    planted types y of each fold, a (G, allc_pad, allc_pad) problem, and
    each problem's count of real points."""
    import torch

    from sharp_tpu_torch.core.pipeline import _allc_pad
    from sharp_tpu_torch.core.wmetac import cluster_similarity
    from sharp_tpu_torch.ops.select import prep_distance

    rng = np.random.default_rng(seed)
    labels = np.full((len(ys), n_pad, cfg.ensize_K), cfg.nc_pad - 1, np.int32)
    for g, y in enumerate(ys):
        labels[g, : len(y)] = _wmetac_like_labels(y, cfg.ensize_K, cfg.nc_pad, rng)
    n = torch.tensor([len(y) for y in ys], device=dev)
    mask = torch.arange(n_pad, device=dev)[None, :] < n[:, None]
    allc = _allc_pad(cfg)
    sim = cluster_similarity(
        torch.from_numpy(labels).to(dev), mask, n,
        K=cfg.ensize_K, nc_pad=cfg.nc_pad, allc_pad=allc,
    )
    D, _, _ = prep_distance(sim.S, sim.comp_valid, symmetric=True)
    return D.contiguous(), torch.clamp_max(sim.total_occ, allc).tolist()


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes, flops=0.0):
    """The least time (ms) the card could take: bytes over the memory rate
    or float32 operations over the float32 rate, whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _hold_ward(name, D, n_real, store_name, plain_reps=PLAIN_REPS):
    """Serial Ward on D in one storage type against its plain version:
    merges and heights identical; its time, microseconds per merge, the
    plain version's time and the bound. n_real: the problems' count of real
    points, one for all or a list. Returns the row and the merges."""
    import torch

    from sharp_tpu_torch.ops.linkage import ward_linkage
    from sharp_tpu_torch.ops.linkage_cuda import ward_linkage_serial

    store = {"f32": torch.float32, "bf16": torch.bfloat16}[store_name]
    K, n = D.shape[0], D.shape[-1]
    got = ward_linkage_serial(D, store_dtype=store)
    ref = ward_linkage(D, store_dtype=store)
    torch.cuda.synchronize()
    if not torch.equal(got.merges, ref.merges):
        bad = (got.merges != ref.merges).any(-1).nonzero()
        raise AssertionError(f"{name} {store_name}: merges differ from the plain loop at {bad[:5].tolist()}")
    err = float((got.heights - ref.heights).abs().max())
    if not torch.equal(got.heights, ref.heights):
        raise AssertionError(f"{name} {store_name}: heights differ from the plain loop (max abs {err})")
    # D read once, merges and heights written once; n - 1 merge steps of
    # about 10 float32 operations per column
    bound, by = _bound(_nbytes(D, got.merges, got.heights), 10.0 * K * (n - 1) * n)
    ms = _median_ms(lambda: ward_linkage_serial(D, store_dtype=store), KERNEL_REPS)
    row = dict(
        shape=[K, n], n_real=n_real, store=store_name, max_abs_err=err, ms=ms,
        us_per_merge=1e3 * ms / (n - 1), bound_ms=bound, bound_by=by,
        plain_ms=_median_ms(lambda: ward_linkage(D, store_dtype=store), plain_reps),
    )
    _device_ms_later(row, "device_ms", lambda: ward_linkage_serial(D, store_dtype=store),
                     "ward_serial_kernel", f"ward_serial {name} {store_name}")
    print(
        f"[kernels] ward_serial {name} {store_name} K={K} n={n} n_real={n_real}: merges and heights "
        f"identical to the plain loop; {ms:.3f} ms, {row['us_per_merge']:.2f} us per merge (plain "
        f"{row['plain_ms']:.3f} ms, bound {bound * 1e3:.2f} us)",
        flush=True,
    )
    return row, got.merges


def _hold_ward_and_cutree(name, D, n_real, record_rows, ncand=39, stores=("f32", "bf16")):
    """Serial Ward on D in each storage type, and the cut replay on its f32
    merges, against their plain versions; n_real one count for all problems
    or a list."""
    K = D.shape[0]
    nr = list(n_real) if isinstance(n_real, (list, tuple)) else [n_real] * K
    row = {}
    for store_name in stores:
        row[store_name], merges = _hold_ward(name, D, n_real, store_name)
        if store_name == "f32":
            _hold_cutree(name, merges, nr, ncand, row=row)
            print(
                f"[kernels] cutree {name}: cut snapshots identical to the plain replay; "
                f"{row['cutree_ms']:.3f} ms (plain {row['cutree_plain_ms']:.3f} ms)",
                flush=True,
            )
    record_rows[name] = row
    return row


def _smetac_like_problem(dev, n_pad, n_real, seed, clusters=40, dim=64):
    """A tie-heavy sMetaC-like problem (1, n_pad, n_pad): Pearson distances
    of n_real fold centroids that are n_real / clusters near-duplicate
    replicas of each of `clusters` cell types, half of them exact copies
    (exact zero distances), as one type's centroid recurs in every fold."""
    import torch

    from sharp_tpu_torch.ops.select import prep_distance

    rng = np.random.default_rng(seed)
    C = rng.normal(size=(clusters, dim))
    y = np.arange(n_real) % clusters
    noise = 1e-3 * rng.normal(size=(n_real, dim)) * (rng.random((n_real, 1)) < 0.5)
    X = np.zeros((n_pad, dim), np.float32)
    X[:n_real] = C[y] + noise
    mask = torch.arange(n_pad, device=dev) < n_real
    D, _, _ = prep_distance(torch.from_numpy(X).to(dev), mask, symmetric=False)
    return D[None].contiguous()


def _random_problem(dev, K, n_pad, n_real, seed, dim=32):
    """Pearson distances of K problems of n_real random points padded to
    n_pad, (K, n_pad, n_pad)."""
    import torch

    from sharp_tpu_torch.ops.select import prep_distance
    from sharp_tpu_torch.utils.prng import fixed_generator

    Z = torch.zeros((K, n_pad, dim), device=dev)
    Z[:, :n_real] = torch.randn((K, n_real, dim), generator=fixed_generator(seed, dev), device=dev)
    mask = torch.arange(n_pad, device=dev) < n_real
    D, _, _ = prep_distance(Z, mask, symmetric=False)
    return D.contiguous()


def _hold_cutree(name, merges, nr, ncand, minN=2, row=None):
    """The cut replay against the plain replay; its numbers go into `row`
    (a new dict by default), which is returned."""
    import torch

    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.ops.linkage import cutree_snapshots
    from sharp_tpu_torch.ops.linkage_cuda import cutree_snapshots_kernel

    snaps = cutree_snapshots_kernel(merges, nr, minN=minN, ncand=ncand)
    serial = int(linkage_cuda.ROUTES["cutree"].sum())
    snaps_ref = cutree_snapshots(merges, nr, minN=minN, ncand=ncand)
    torch.cuda.synchronize()
    if not torch.equal(snaps, snaps_ref):
        raise AssertionError(f"{name}: cut snapshots differ from the plain replay")
    if serial:
        raise AssertionError(f"{name}: {serial} of {len(nr)} linkage problems took the serial route")
    # the merges up to each problem's last snapshot step read once, n_real
    # read once, the snapshots written once
    n = merges.shape[1] + 1
    steps = sum(max(min(r - 1 - minN, n - 2) + 1, 0) for r in nr)
    bound, by = _bound(8 * steps + 4 * len(nr) + _nbytes(snaps))
    row = {} if row is None else row
    row.update(
        cutree_bound_ms=bound, cutree_bound_by=by,
        cutree_max_abs_err=float((snaps - snaps_ref).abs().max()),
        cutree_ms=_median_ms(
            lambda: cutree_snapshots_kernel(merges, nr, minN=minN, ncand=ncand), KERNEL_REPS
        ),
        cutree_plain_ms=_median_ms(
            lambda: cutree_snapshots(merges, nr, minN=minN, ncand=ncand), PLAIN_REPS
        ),
    )
    _device_ms_later(row, "cutree_device_ms",
                     lambda: cutree_snapshots_kernel(merges, nr, minN=minN, ncand=ncand),
                     "cutree_kernel", f"cutree {name}")
    return row


SWEEP_KERNELS = ("sweep_nodes", "sweep_score", "sweep_median")


def _hold_sweep(name, D_real, feats, merges, nr, mask, maxN=40, minN=2, ncand=39, nc_pad=48):
    """The selection sweep through its three kernels against the plain sweep
    on the card, on one cut replay of `merges`: one launch of each kernel,
    msil identical, CH within 1e-5 relative; ms a call through each route
    (the kernels' with the torch preamble), the three kernels alone, and
    their bound: the sums and FC tables read once, the own table and the
    widths and CH terms written once and read once."""
    import torch

    from sharp_tpu_torch.ops import silhouette
    from sharp_tpu_torch.ops.linkage_cuda import cutree_multi_kernel

    kw = dict(minN=minN, ncand=ncand, nc_pad=nc_pad)
    cuts = cutree_multi_kernel(merges, nr, mask, maxN, **kw)
    args = (D_real, feats, merges, cuts.labels, mask, nr, maxN)
    before = dict(silhouette.LAUNCHES)
    msil, ch = silhouette.sweep_scores_nested(*args, **kw)
    pm, pc = silhouette.sweep_scores_nested_plain(*args, **kw)
    torch.cuda.synchronize()
    launched = {k: silhouette.LAUNCHES[k] - before[k] for k in before}
    if launched != dict.fromkeys(SWEEP_KERNELS, 1):
        raise AssertionError(f"{name}: the sweep launched {launched}, not each kernel once")
    if not torch.equal(msil, pm):
        raise AssertionError(f"{name}: msil differs from the plain sweep by {float((msil - pm).abs().max())}")
    ch_err = float(((ch - pc).abs() / pc.abs().clamp_min(1e-30)).max())
    if ch_err > 1e-5:
        raise AssertionError(f"{name}: CH differs from the plain sweep by {ch_err} relative")
    L, n = D_real.shape[0], D_real.shape[-1]
    bound, by = _bound(2 * L * n * (nc_pad + ncand) * 4 + 2 * L * ncand * n * (1 + 2 * 4))
    row = dict(
        shape=[L, n, ncand, nc_pad], ch_max_rel_err=ch_err, bound_ms=bound, bound_by=by,
        ms=_median_ms(lambda: silhouette.sweep_scores_nested(*args, **kw), KERNEL_REPS),
        plain_ms=_median_ms(lambda: silhouette.sweep_scores_nested_plain(*args, **kw), PLAIN_REPS),
    )
    # now, not deferred to the run's end with the others: the inputs (a 1.3 GB
    # D_real) would stay on the card through phase 8 (c), whose processes
    # size their fold groups from its free memory
    row["device_ms"] = _device_ms(lambda: silhouette.sweep_scores_nested(*args, **kw), SWEEP_KERNELS)
    print(
        f"[kernels] sweep {name}: msil identical to the plain sweep, CH within {ch_err:.2e}; "
        f"{row['ms']:.3f} ms a call (plain {row['plain_ms']:.3f} ms, the kernels alone {row['device_ms']} ms, "
        f"bound {bound * 1e3:.2f} us)",
        flush=True,
    )
    return row

def _fold_group_features(X, dev, sizes=None, cfg=None):
    """A fold group of the large path on X: G=16 folds (of 2,000 cells, or
    `sizes`) at n_pad 2048, log2, projected K ways with one ternary RP
    matrix -> the (G*K, 2048, p) projections (pads zero), their mask and
    real counts (G*K lanes) and the config (X's own, or `cfg`'s K and
    projection width)."""
    import torch

    from sharp_tpu_torch.config import pad_dim, resolve_config
    from sharp_tpu_torch.ops.rp import rp_project_ensemble, ternary_rp_matrix
    from sharp_tpu_torch.utils.prng import fixed_generator

    n, genes = X.shape
    cfg = cfg or resolve_config(n, genes, **SEED_KW)
    K, p, B = cfg.ensize_K, cfg.reduced_ndim, pad_dim(FOLD)
    sizes = sizes or (FOLD,) * GROUP
    Xg = torch.zeros((GROUP, B, genes), device=dev)
    for g, z in enumerate(sizes):
        Xg[g, :z] = torch.from_numpy(X[g * FOLD : g * FOLD + z]).to(dev)
    R = ternary_rp_matrix(fixed_generator(0, dev), genes, K * p)
    proj = rp_project_ensemble(torch.log2(1.0 + Xg).reshape(GROUP * B, genes), R, K=K)
    del Xg
    proj = proj.reshape(K, GROUP, B, p).transpose(0, 1).reshape(GROUP * K, B, p)
    n_real = torch.tensor(sizes, device=dev).repeat_interleave(K)
    mask = torch.arange(B, device=dev)[None, :] < n_real[:, None]
    return proj * mask[..., None], mask, n_real, cfg


def _fold_group_distances(X, dev, sizes=None, cfg=None):
    """`_fold_group_features`' group as (G*K, 2048, 2048) Pearson distances,
    and the config."""
    from sharp_tpu_torch.ops.select import prep_distance

    proj, mask, _, cfg = _fold_group_features(X, dev, sizes, cfg)
    D, _, _ = prep_distance(proj, mask, symmetric=False)
    return D.contiguous(), cfg


def _small_tier_distance(dev, n_cells):
    """The small tier's block linkage input at (a) (479 cells) or (b)
    (1,000): 20,000 genes, 7 planted types (data seed 0), log2, projected
    K ways with one ternary RP matrix (seed 0) -> (K, n_pad, n_pad) Pearson
    distances and the count of real points."""
    import torch

    from sharp_tpu_torch.config import pad_dim, resolve_config
    from sharp_tpu_torch.ops.rp import rp_project_ensemble, ternary_rp_matrix
    from sharp_tpu_torch.ops.select import prep_distance
    from sharp_tpu_torch.utils.prng import fixed_generator
    from synth import make_tpm_like

    cfg = resolve_config(n_cells, 20000, **SEED_KW)
    X, _ = make_tpm_like(n_cells=n_cells, n_genes=20000, n_types=7, seed=0)
    n_pad = pad_dim(n_cells)
    Xp = torch.zeros((n_pad, 20000), device=dev)
    Xp[:n_cells] = torch.from_numpy(np.log2(1.0 + X)).to(dev)
    mask = torch.arange(n_pad, device=dev) < n_cells
    R = ternary_rp_matrix(fixed_generator(0, dev), 20000, cfg.ensize_K * cfg.reduced_ndim)
    proj = rp_project_ensemble(Xp, R, K=cfg.ensize_K) * mask[None, :, None]
    D, _, _ = prep_distance(proj, mask, symmetric=False)
    return D.contiguous(), n_cells


def _device_breakdown(fn, reps=KERNEL_REPS):
    """Every device kernel of fn on the card (torch.profiler): {name: mean
    ms a call of fn} over `reps` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
        if t > 0 and ev.device_type is not None and "CPU" not in str(ev.device_type):
            out[ev.key] = t / reps / 1e3
    return out


def _hold_rp(dev, Xbig):
    """The RP product at the main path's shape: a fold group's 16 x 2,048
    rows of the flagship block, 27,998 genes, the atlas's K=5 x p=256 in
    bfloat16. The operand kernel identical to its plain version (pads
    zero), the tensor-core product within 1e-6 norm-wise of the float64
    product of the same operands; each timed beside its bound (operand:
    bytes; product: bf16 operations over the tensor cores' rate), the plain
    operand's time, today's float32 torch.matmul of the same operands
    (library_ms), and the whole stage against the float32 stage it
    replaces."""
    import torch
    import torch.nn.functional as F

    from sharp_tpu_torch.ops import rp
    from sharp_tpu_torch.utils.prng import fixed_generator

    n, genes = GROUP * 2048, Xbig.shape[1]
    cols = -(-genes // 8) * 8
    X = torch.from_numpy(Xbig[:n]).to(dev)
    R = rp.ternary_rp_matrix(fixed_generator(0, dev), genes, RP_K * RP_P).to(torch.bfloat16)
    Rpad = F.pad(R, (0, 0, 0, cols - genes))
    bf16 = torch.bfloat16
    Xb = rp.rp_operand(X, bf16, True)
    plain = rp.rp_operand_plain(X, bf16, True, cols)
    if not torch.equal(Xb.view(torch.int16), plain.view(torch.int16)):
        raise AssertionError("rp_operand: the kernel and its plain version disagree")
    del plain
    prod = torch.mm(Xb, Rpad, out_dtype=torch.float32)
    ref = Xb.double() @ Rpad.double()
    err = ((prod.double() - ref).norm() / ref.norm()).item()
    del ref, prod
    if not err < 1e-6:
        raise AssertionError(f"rp product: norm-wise relative error {err} against float64, limit 1e-6")
    scale = torch.tensor(float(RP_P), device=dev).rsqrt()

    def before():
        # the float32 stage this replaces: log2, bf16 rounding, a float32
        # copy, the float32 product, the scale
        out = torch.matmul(rp.log2p1(X).to(bf16).float(), R.float())
        return (out * scale).reshape(n, RP_K, RP_P).permute(1, 0, 2).contiguous()

    flops = 2.0 * n * genes * RP_K * RP_P
    row = dict(
        shape=[n, genes, RP_K * RP_P], product_rel_err=err,
        operand_ms=_median_ms(lambda: rp.rp_operand(X, bf16, True), KERNEL_REPS),
        operand_plain_ms=_median_ms(lambda: rp.rp_operand_plain(X, bf16, True, cols), PLAIN_REPS),
        operand_bound_ms=(X.numel() * 4 + n * cols * 2) / HBM_BYTES_PER_S * 1e3,
        product_ms=_median_ms(lambda: torch.mm(Xb, Rpad, out_dtype=torch.float32), KERNEL_REPS),
        product_bound_ms=flops / BF16_FLOPS * 1e3,
        stage_ms=_median_ms(lambda: rp.rp_project_ensemble(X, R, K=RP_K, log_transform=True), KERNEL_REPS),
        stage_before_ms=_median_ms(before, PLAIN_REPS),
    )
    Xf, Rf = Xb.float(), Rpad.float()
    row["library_ms"] = _median_ms(lambda: torch.matmul(Xf, Rf), PLAIN_REPS)
    del Xf, Rf
    row["operand_device"] = _device_breakdown(lambda: rp.rp_operand(X, bf16, True))
    row["product_device"] = _device_breakdown(lambda: torch.mm(Xb, Rpad, out_dtype=torch.float32))
    row["stage_device"] = _device_breakdown(lambda: rp.rp_project_ensemble(X, R, K=RP_K, log_transform=True))
    print(
        f"[kernels] rp_operand ({n}, {genes}) -> bf16 ({n}, {cols}): identical to the plain version; "
        f"{row['operand_ms']:.3f} ms (plain {row['operand_plain_ms']:.3f} ms, bound {row['operand_bound_ms']:.3f} ms "
        f"of bytes); device {row['operand_device']}",
        flush=True,
    )
    print(
        f"[kernels] rp product ({n} x {cols}) x ({cols} x {RP_K * RP_P}) bf16 -> f32 on the tensor cores: "
        f"{row['product_ms']:.3f} ms (bound {row['product_bound_ms']:.3f} ms of bf16 operations; float32 "
        f"torch.matmul, library_ms, {row['library_ms']:.3f} ms); norm-wise error {err:.3e}; device "
        f"{row['product_device']}",
        flush=True,
    )
    print(
        f"[kernels] rp stage (log2, operand, product, scale and layout): {row['stage_ms']:.3f} ms; the float32 "
        f"stage it replaces {row['stage_before_ms']:.3f} ms; device {row['stage_device']}",
        flush=True,
    )
    del X, Xb, R, Rpad
    torch.cuda.empty_cache()
    return row


def _hold_tail(name, args):
    """The tail kernel on the ladder's compacted subproblems `args`
    (`RnnLadder.tail_inputs()`) against the plain tail: mi, mj, hh identical
    for t < n_alive - 1; its time, the plain tail's, the bound and the lanes
    by route (ROUTES). Returns the row and the plain tail's output."""
    import torch

    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.ops.linkage import rnn_tail
    from sharp_tpu_torch.ops.linkage_cuda import rnn_tail_kernel

    L, Cn = args[0].shape[:2]
    got = rnn_tail_kernel(*args)
    rows_route = int(linkage_cuda.ROUTES["rnn_tail"].sum())
    ref = rnn_tail(*args)
    torch.cuda.synchronize()
    n_alive = args[1].sum(dim=1).long()
    valid = torch.arange(Cn, device=n_alive.device)[None, :] < (n_alive - 1)[:, None]
    for what, a, b in zip(("mi", "mj", "hh"), got, ref):
        if not torch.equal(a[valid], b[valid]):
            raise AssertionError(f"{name}: {what} differs from the plain tail")
    # D read once, (mi, mj, hh) written once; the state vectors read once
    bound, by = _bound(_nbytes(*args, *got))
    row = dict(
        shape=[L, Cn], n_alive_min=int(n_alive.min()), n_alive_max=int(n_alive.max()),
        lanes_by_route={"triangle": L - rows_route, "rows": rows_route},
        max_abs_err=float((got[2] - ref[2])[valid].abs().max()), bound_ms=bound, bound_by=by,
        ms=_median_ms(lambda: rnn_tail_kernel(*args), KERNEL_REPS),
        plain_ms=_median_ms(lambda: rnn_tail(*args), PLAIN_REPS),
    )
    print(
        f"[kernels] {name} L={L} Cn={Cn} (n_alive {row['n_alive_min']}-{row['n_alive_max']}; lanes by route "
        f"{row['lanes_by_route']}): mi, mj, hh identical to the plain tail; kernel {row['ms']:.3f} ms (plain "
        f"{row['plain_ms']:.3f} ms, bound {bound * 1e3:.2f} us)",
        flush=True,
    )
    _device_ms_later(row, "device_ms", lambda: rnn_tail_kernel(*args), "rnn_tail_kernel", f"{name} ({L}, {Cn})")
    return row, ref


def phase_kernels(dev, record, Xbig, ybig):
    import torch

    from sharp_tpu_torch.config import pad_dim, resolve_config
    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.ops.linkage import validate_merge_sequence, ward_linkage_rnn
    from sharp_tpu_torch.ops.linkage_cuda import cutree_snapshots_kernel

    rows = {}
    record["rp"] = _hold_rp(dev, Xbig)
    # --- small-tier shapes -------------------------------------------------
    cfg = resolve_config(479, 20000, **SEED_KW)
    _hold_ward_and_cutree("ward_15x512", *_small_tier_distance(dev, 479), rows)
    y = np.random.default_rng(1).integers(0, 7, 479)
    D, n_real = _wmetac_problem(dev, cfg, [y], 512, seed=0)
    _hold_ward_and_cutree(f"ward_1x{D.shape[-1]}", D, n_real, rows)
    n_pad = pad_dim(1000)
    _hold_ward_and_cutree(f"ward_1x{n_pad}", _random_problem(dev, 1, n_pad, 1000, seed=1, dim=250), 1000, rows)
    # tied sMetaC-like centroids at n_pad 1024; both sides of the
    # shared-memory tier (n <= 256); bf16 storage at the large tier's 2048
    _hold_ward_and_cutree("ward_smetac_1x1024", _smetac_like_problem(dev, 1024, 1000, seed=3), 1000, rows)
    _hold_ward_and_cutree("ward_2x200", _random_problem(dev, 2, 200, 190, seed=4), 190, rows)
    _hold_ward_and_cutree("ward_2x257", _random_problem(dev, 2, 257, 250, seed=5), 250, rows)
    rows["ward_1x2048"] = {"bf16": _hold_ward("ward_1x2048", _random_problem(dev, 1, 2048, 2000, seed=6),
                                              2000, "bf16")[0]}
    # above n 8192 the row cache's state leaves shared memory for a global
    # scratch (no size cap): one problem at n 8320
    rows["ward_1x8320"] = {"f32": _hold_ward("ward_1x8320", _random_problem(dev, 1, 8320, 8280, seed=7),
                                             8280, "f32", plain_reps=1)[0]}

    # --- large-tier shapes: the first fold group of the flagship block ------
    D, big_cfg = _fold_group_distances(Xbig, dev)
    L = D.shape[0]
    tail, rounds, rounds_per_level, ladders = {}, {}, {}, {}
    links = {}
    for store_name, store in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        # the ladder with kernel rounds, every round held against the plain
        # round, keeping the state before the first round at each level and
        # the survivor state it compacts down to
        ladder, first, per_level, held = _capture_rounds(D, store)
        print(f"[kernels] rnn_round {store_name}: {held} rounds of the ladder ({L}, {D.shape[-1]}) each "
              f"identical to the plain round (matrix, row cache, cluster and merge state); rounds per level "
              f"{per_level}", flush=True)
        # the first round at the two largest levels (2048 and 1024 here)
        rounds[store_name] = {
            m: _hold_round(f"rnn_round {store_name} m={m} first round", first[m])
            for m in sorted(first, reverse=True)[:2]
        }
        rounds_per_level[store_name] = per_level
        del first
        args = ladder.tail_inputs()
        tail[store_name], ref = _hold_tail(f"rnn_tail {store_name}", args)
        # the whole ladder: kernel rounds and kernel tail against the same
        # rounds finished by the plain tail, and against plain rounds
        link = ward_linkage_rnn(D, store_dtype=store, round_impl="pallas")
        plain_tail = ladder.finish(*ref)
        plain_rounds = ward_linkage_rnn(D, store_dtype=store, round_impl="xla")
        for what, other in (("the plain tail", plain_tail), ("plain rounds", plain_rounds)):
            if not (torch.equal(link.merges, other.merges) and torch.equal(link.heights, other.heights)):
                raise AssertionError(f"ladder {store_name}: the kernels and {what} disagree")
        del ladder, plain_tail, plain_rounds
        for lane in (0, L - 1):
            errs = validate_merge_sequence(link.merges[lane], link.heights[lane], FOLD, D.shape[-1])
            if errs:
                raise AssertionError(f"ladder {store_name} lane {lane}: {errs}")
        links[store_name] = link
        print(f"[kernels] the whole ladder {store_name} identical with the plain tail and with plain rounds; "
              f"rounds per level {per_level}", flush=True)
        del args, ref
        # the whole ladder with plain rounds and with kernel rounds, in turns
        turns = {}
        for impl in ("xla", "pallas", "pallas", "xla"):
            turns.setdefault(impl, []).append(
                _median_ms(lambda: ward_linkage_rnn(D, store_dtype=store, round_impl=impl), 3)
            )
        ladders[store_name] = {impl: float(np.mean(v)) for impl, v in turns.items()}
        ladders[store_name]["turns_ms"] = turns
        print(
            f"[kernels] ladder ({L}, {D.shape[-1]}) {store_name}: plain rounds {ladders[store_name]['xla']:.3f} ms, "
            f"kernel rounds {ladders[store_name]['pallas']:.3f} ms (means of the medians of 3 in turns "
            f"xla, pallas, pallas, xla: {turns})",
            flush=True,
        )
        torch.cuda.empty_cache()
    record["ladder_80x2048_ms"] = ladders
    del D
    torch.cuda.empty_cache()
    record["pad_group"] = _pad_group(dev, Xbig, rounds)
    record["rnn_tail"] = tail
    record["rnn_round"] = {st: {str(m): row for m, row in r.items()} for st, r in rounds.items()}
    record["rnn_round_rounds_per_level"] = {st: {str(m): c for m, c in r.items()} for st, r in rounds_per_level.items()}
    big = _hold_cutree("cutree_80x2048", links["f32"].merges, [FOLD] * L, 39)
    big["shape"] = list(links["f32"].merges.shape[:2])
    rows["cutree_80x2048"] = big
    print(
        f"[kernels] cutree_80x2048 on the ladder's merges: identical to the plain replay; "
        f"{big['cutree_ms']:.3f} ms (plain {big['cutree_plain_ms']:.3f} ms, bound "
        f"{big['cutree_bound_ms'] * 1e3:.2f} us)",
        flush=True,
    )
    # the selection sweep on the same group's lanes and merges
    from sharp_tpu_torch.ops.select import prep_distance

    proj, mask, n_real, _ = _fold_group_features(Xbig, dev)
    _, D_real, feats = prep_distance(proj, mask, symmetric=False)
    del proj
    record["sweep_80x2048"] = _hold_sweep("80x2048", D_real, feats, links["f32"].merges, n_real, mask)
    del D_real, feats
    torch.cuda.empty_cache()
    # the launch floor: the same kernel on a two-cell problem, which has no
    # snapshot step, with n_real from the host (as the pipeline passes it)
    # and already on the card, and the kernel's own time
    pair = torch.zeros((1, 1, 2), dtype=torch.int32, device=dev)
    pair[0, 0, 1] = 1
    two = torch.full((1,), 2, dtype=torch.int32, device=dev)
    floor = record["cutree_launch_floor"] = dict(
        host_n_real_ms=_median_ms(lambda: cutree_snapshots_kernel(pair, [2], minN=2, ncand=39), KERNEL_REPS),
        device_n_real_ms=_median_ms(lambda: cutree_snapshots_kernel(pair, two, minN=2, ncand=39), KERNEL_REPS),
    )
    print(f"[kernels] cutree launch floor (1, 2): {floor}", flush=True)
    _device_ms_later(floor, "device_ms", lambda: cutree_snapshots_kernel(pair, two, minN=2, ncand=39),
                     "cutree_kernel", "cutree launch floor (1, 2)")
    del links
    D, n_real = _wmetac_problem(dev, big_cfg, [ybig[:FOLD]], pad_dim(FOLD), seed=2)
    _hold_ward_and_cutree("ward_wmetac_fold", D, n_real, rows)
    # the shape the main path gives both kernels now: one fold group's 16
    # wMetaC meta problems in one launch
    D, n_real = _wmetac_problem(dev, big_cfg, [ybig[g * FOLD : (g + 1) * FOLD] for g in range(GROUP)],
                                pad_dim(FOLD), seed=2)
    _hold_ward_and_cutree(f"ward_wmetac_{GROUP}x{D.shape[-1]}", D, n_real, rows)
    record["kernels"] = rows
    torch.cuda.empty_cache()
    return rows, tail, rounds


LADDER_FIELDS = ("D", "alive", "sizes", "gidx", "lasth", "merges", "heights", "cnt", "rounds")
# the bench's last fold group (PERF.md section 5 (o)): 14 folds of 2,000
# cells and its folds of 1,063 and 1,064, whose ~985 pad rows merge one pair
# a round
PAD_GROUP = (FOLD,) * (GROUP - 2) + (1063, 1064)
# the pad round held and timed: this round of level 1024 of PAD_GROUP, when
# only the 10 lanes of the two short folds are live, one pair each
PAD_ROUND = (1024, 60)


def round_bytes(before, after, P):
    """The bytes one ladder round must move, from the ladder states before
    and after it (the row cache of both set), each input read once and each
    output written once. Reads: every lane's alive flags and counters; the
    active lanes' row cache (the selection); the live lanes' sizes (those
    with a pair: the fresh rows); lasth and gidx at the pairs; rows a and b
    of each real pair; the rows whose cached minimum's column grew, whose
    minimum no cache can give. Writes: the changed entries of W and of the
    row cache; sizes, lasth, alive, merges and heights at the pairs; the
    active lanes' counters. The pairs' fresh rows are a buffer inside the
    round, not an output. Returns a dict of that count ("bytes"), the count
    with W of the live lanes read whole in place of those rows
    ("live_w_bytes"), the earlier kernel's count (all of W read and
    written, the (L, P, m) fresh rows and the column codes read, the row
    cache written: "old_bytes"), the pairs' kernels' own count (the
    selection's reads and writes, rows a and b read, the fresh rows, pair-
    pair entries, column codes and pair slots written: "pairs_bytes"), and
    the live lanes, real pairs, rows read again and changed entries."""
    W0, W1 = before.D, after.D
    L, m, _ = W0.shape
    es = W0.element_size()
    pairs = after.cnt - before.cnt
    live = pairs > 0
    n_active = int((after.rounds != before.rounds).sum())
    n_live, n_pairs = int(live.sum()), int(pairs.sum())
    changed = int((W0.view(-1, m * m)[live] != W1.view(-1, m * m)[live]).sum())
    dying = before.alive & ~after.alive
    survivor = after.sizes != before.sizes
    rowmin, i0 = before.rowcache
    grew = W1.gather(2, i0[..., None])[..., 0].float() > rowmin
    again = after.alive & ~survivor & (dying | survivor).gather(1, i0) & grew
    n_again = int(again.sum())
    cache_changed = int(((after.rowcache[0] != rowmin) | (after.rowcache[1] != i0)).sum())
    # alive flags and cnt, rounds of every lane; row cache (4 + 8) of the
    # active lanes; sizes of the live lanes; lasth (4) and gidx (8) of a and b
    select = L * (m + 16) + n_active * m * 12 + n_live * m * 4 + n_pairs * 24
    # lasth, alive, merges, heights at a pair (4 + 1 + 8 + 4) and the
    # counters; then sizes at a pair
    books = n_pairs * 17 + n_active * 16
    written = changed * es + cache_changed * 12 + books + n_pairs * 4
    return dict(
        bytes=select + (2 * n_pairs + n_again) * m * es + written,
        live_w_bytes=select + n_live * m * m * es + written,
        old_bytes=2 * L * m * m * es + L * P * m * es + L * m * (4 + 1) + L * m * (4 + 8),
        pairs_bytes=select + 3 * n_pairs * m * es + int((pairs * pairs).sum()) * 4 + n_live * m * 4
        + n_pairs * 20 + books,
        live_lanes=n_live, pairs=n_pairs, rows_read_again=n_again, changed_entries=changed,
    )


def _ladder_copy(ladder, device=None):
    """A ladder with copies of every tensor of `ladder` (row cache too), on
    `device` (default: where they are)."""
    import copy

    def cp(x):
        return x.clone() if device is None else x.to(device, copy=True)

    out = copy.copy(ladder)
    for name in LADDER_FIELDS:
        setattr(out, name, cp(getattr(ladder, name)))
    out.rowcache = None if ladder.rowcache is None else tuple(cp(x) for x in ladder.rowcache)
    out.scratch = None
    out.level_rounds = list(ladder.level_rounds)
    return out


def _restore(dst, src):
    """Copy the state of ladder `src` into ladder `dst` in place."""
    for name in LADDER_FIELDS:
        getattr(dst, name).copy_(getattr(src, name))
    for a, b in zip(dst.rowcache, src.rowcache):
        a.copy_(b)


def _same_ladder(name, a, b):
    import torch

    for field in LADDER_FIELDS:
        if not torch.equal(getattr(a, field), getattr(b, field)):
            raise AssertionError(f"{name}: {field} differs from the plain round")
    if not all(torch.equal(x, y) for x, y in zip(a.rowcache, b.rowcache)):
        raise AssertionError(f"{name}: the row cache differs from the plain round")


def _capture_rounds(D, store, keep=None, pair_cap=128):
    """The ladder over D with kernel rounds (up to pair_cap pairs a round),
    each round held against the plain round `rnn_round` on a copy of the
    ladder: the whole state and the row cache identical. Returns the ladder
    (compacted to its tail), copies
    of the state (ladder, nxt, P) before the first round at each level size
    (and before round `keep` = (m, t), the t-th of level m, under that key),
    the rounds launched per level and the rounds held."""
    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.ops.linkage import rnn_ladder, rnn_round

    real = linkage_cuda.rnn_round_kernel
    first, per_level = {}, {}

    def spy(ladder, nxt, P):
        m = ladder.D.shape[-1]
        per_level[m] = per_level.get(m, 0) + 1
        ladder.row_cache()
        plain = _ladder_copy(ladder)
        if m not in first:
            first[m] = (_ladder_copy(ladder), nxt, P)
        if keep == (m, per_level[m]):
            first[keep] = (_ladder_copy(ladder), nxt, P)
        real(ladder, nxt, P)
        rnn_round(plain, nxt, P)
        _same_ladder(f"rnn_round {ladder.D.dtype} m={m} round {per_level[m]}", ladder, plain)

    linkage_cuda.rnn_round_kernel = spy
    try:
        ladder = rnn_ladder(D, pair_cap, store, round_impl="pallas")
    finally:
        linkage_cuda.rnn_round_kernel = real
    return ladder, first, per_level, sum(per_level.values())


def _hold_round(name, state, reps=KERNEL_REPS):
    """The round kernel against the plain round `rnn_round` from one saved
    state (ladder, nxt, P): identical ladders after it; the kernel's time
    (CUDA events around the round alone, the state restored and the L2
    cache flushed before each), the plain round's, the bound counted from
    what this round needs and by the earlier kernel's count (`round_bytes`),
    and the kernels' own times."""
    import torch

    from sharp_tpu_torch.ops.linkage import rnn_round
    from sharp_tpu_torch.ops.linkage_cuda import rnn_round_kernel

    saved, nxt, P = state
    work, plain = _ladder_copy(saved), _ladder_copy(saved)
    rnn_round_kernel(work, nxt, P)
    rnn_round(plain, nxt, P)
    torch.cuda.synchronize()
    _same_ladder(name, work, plain)
    err = float((work.rowcache[0] - plain.rowcache[0]).abs().max())
    nb = round_bytes(saved, work, P)
    del plain
    flush = torch.empty(2 * 50 * 2**20 // 4, dtype=torch.float32, device=work.D.device)

    def timed(fn, n):
        times = []
        for _ in range(n):
            _restore(work, saved)
            flush.fill_(1.0)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(work, nxt, P)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    L, m, _ = saved.D.shape
    bound, by = _bound(nb["bytes"])
    old_bound = _bound(nb["old_bytes"])[0]
    row = dict(
        shape=[L, m, P], dtype=str(saved.D.dtype), max_abs_err=err, bound_ms=bound, bound_by=by,
        old_count_bound_ms=old_bound, live_w_bound_ms=_bound(nb["live_w_bytes"])[0],
        pairs_bound_ms=_bound(nb["pairs_bytes"])[0], **nb,
        ms=timed(rnn_round_kernel, reps), plain_ms=timed(rnn_round, PLAIN_REPS),
    )

    # the state waits for the profiler in host memory, so that the card's
    # memory stays free for the later phases (their fold groups are sized
    # from it)
    dev, host, state = work.D.device, _ladder_copy(saved, "cpu"), []
    del work, saved

    def again():
        if not state:
            state.append(_ladder_copy(host, dev))
            state.append(_ladder_copy(state[0]))
        _restore(state[1], state[0])
        rnn_round_kernel(state[1], nxt, P)

    # the kernels alone: the scatter with the row cache (rnn_round) and the
    # pairs' selection and fresh rows (rnn_pairs), per round
    _device_ms_later(row, "device_ms", again, ("rnn_round_scatter",), name)
    _device_ms_later(row, "pairs_device_ms", again, ("rnn_pairs_select", "rnn_pairs_rows"), name + " (pairs)")
    print(
        f"[kernels] {name} L={L} P={P} ({nb['live_lanes']} live lanes, {nb['pairs']} pairs, "
        f"{nb['rows_read_again']} rows read again, {nb['changed_entries']} entries changed): matrix, row cache "
        f"and ladder state identical to the plain round; kernel {row['ms']:.3f} ms (plain {row['plain_ms']:.3f} "
        f"ms); bound {bound:.4f} ms by {by} counting what the round needs, {100 * bound / row['ms']:.1f}% of it "
        f"(with W of the live lanes read whole {row['live_w_bound_ms']:.4f} ms; by the earlier kernel's count of all of W "
        f"read and written {old_bound:.4f} ms, {100 * old_bound / row['ms']:.1f}%)",
        flush=True,
    )
    torch.cuda.empty_cache()
    return row


def _pad_group(dev, Xbig, rounds):
    """The bench's last fold group (PAD_GROUP, 80 lanes at n_pad 2048, 10 of
    them 1,063 or 1,064 real): the whole ladder with kernel rounds against
    plain rounds, merges and heights identical, in f32 and bf16; its time,
    rounds launched and real, host reads; and one pad round (PAD_ROUND)
    held and timed (into `rounds`)."""
    import torch

    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.ops.linkage import LADDER_READ_EVERY, rnn_ladder, rnn_tail, ward_linkage_rnn

    D, _ = _fold_group_distances(Xbig, dev, PAD_GROUP)
    out = {}
    for store_name, store in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ladder, saved, per_level, held = _capture_rounds(D, store, keep=PAD_ROUND)
        rounds[store_name][f"{PAD_ROUND[0]}_pad"] = _hold_round(
            f"rnn_round {store_name} m={PAD_ROUND[0]} pad round {PAD_ROUND[1]}", saved[PAD_ROUND])
        del saved
        kernel = ladder.finish(*rnn_tail(*ladder.tail_inputs()))
        plain = ward_linkage_rnn(D, store_dtype=store, round_impl="xla")
        if not (torch.equal(kernel.merges, plain.merges) and torch.equal(kernel.heights, plain.heights)):
            raise AssertionError(f"pad group {store_name}: the ladder's kernel rounds and plain rounds disagree")
        del ladder, kernel, plain
        torch.cuda.synchronize()
        before = dict(linkage_cuda.LAUNCHES)
        t0 = time.perf_counter()
        ladder = rnn_ladder(D, store_dtype=store, round_impl="pallas")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = linkage_cuda.LAUNCHES["rnn_round"] - before["rnn_round"]
        real = int(sum(int(r) for r in ladder.level_rounds))
        k, levels = LADDER_READ_EVERY, len(ladder.level_rounds)
        if not real <= launched <= real + (k - 1) * levels or (
            linkage_cuda.LAUNCHES["rnn_pairs"] - before["rnn_pairs"] != launched
        ):
            raise AssertionError(f"pad group {store_name}: {launched} rounds launched for {real} rounds with a "
                                 f"lane active over {levels} levels, reading every {k}")
        out[store_name] = dict(
            wall_ms=1e3 * wall, rounds_launched=launched, rounds_real=real, host_reads=ladder.host_reads,
            ms_per_round=1e3 * wall / launched, held_rounds=held, rounds_per_level=per_level,
            read_every=LADDER_READ_EVERY,
        )
        print(
            f"[kernels] pad group {store_name} {tuple(D.shape[:2])}, lanes of {sorted(set(PAD_GROUP))} real: every round "
            f"({held}) identical to the plain round; merges and heights identical to plain rounds; the ladder's "
            f"rounds {1e3 * wall:.1f} ms, {launched} rounds launched ({real} with a lane active, read every "
            f"{LADDER_READ_EVERY}), {1e3 * wall / launched:.3f} ms a round, {ladder.host_reads} host reads",
            flush=True,
        )
        del ladder
        torch.cuda.empty_cache()
    return out


class _RouteLog(dict):
    """`ops.linkage_cuda.ROUTES` that also keeps the route tensor of every
    launch, not only the last one's, without a sync."""

    NAMES = {"cutree": ("parallel", "serial"), "rnn_tail": ("triangle", "rows")}

    def __init__(self):
        super().__init__(dict.fromkeys(self.NAMES))
        self.log = {key: [] for key in self.NAMES}

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.log[key].append(value)

    def counts(self):
        """Problems (cutree) and lanes (rnn_tail) by route, over every launch."""
        import torch

        out = {}
        for key, (zero, one) in self.NAMES.items():
            r = torch.cat(self.log[key]) if self.log[key] else torch.zeros(0, dtype=torch.int32)
            ones = int(r.sum())
            out[key] = {zero: r.numel() - ones, one: ones}
        return out


def _run_counted(X, entry="sharp", **kw):
    """One call of the port's `sharp` (or `sharp_unlimited`) with every
    kernel's launch and problem counts set to 0 just before it and read just
    after, and the routes its cut-replay problems and tail lanes took, and
    its RP products' (`routes["rp"]["tensor_core"]`: the operand kernel's
    launches, one a product on the tensor-core route), and the selection
    sweep's launches by kernel (`routes["sweep"]`).
    Returns (result, wall, launches, problems, routes)."""
    import torch

    import sharp_tpu_torch
    from sharp_tpu_torch.ops import linkage_cuda, rp, silhouette

    log, saved = _RouteLog(), linkage_cuda.ROUTES
    linkage_cuda.ROUTES = log
    try:
        linkage_cuda.SHARD_LAUNCHES.clear()
        linkage_cuda.SHARD_PROBLEMS.clear()
        for counter in (linkage_cuda.LAUNCHES, linkage_cuda.PROBLEMS, rp.LAUNCHES, silhouette.LAUNCHES):
            counter.update(dict.fromkeys(counter, 0))
        t0 = time.perf_counter()
        res = getattr(sharp_tpu_torch, entry)(X, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, problems = dict(linkage_cuda.LAUNCHES), dict(linkage_cuda.PROBLEMS)
        routes = dict(log.counts(), rp={"tensor_core": rp.LAUNCHES["rp_operand"]}, sweep=dict(silhouette.LAUNCHES))
    finally:
        linkage_cuda.ROUTES = saved
    return res, wall, counts, problems, routes


def _stages(res):
    return {s["stage"]: s["seconds"] for s in res.timing["stages"]}


def phase_slice(dev, record):
    from sharp_tpu_torch.analysis.ari import ari
    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.ops.linkage import counts_per_problem
    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch import carry
    from sharp_tpu_torch.core.pipeline import preprocess
    from synth import make_tpm_like

    import sharp_tpu_torch

    out = {}
    for name, n, n_genes, n_types, backend in SLICE_SHAPES:
        kw = dict(SEED_KW, linkage_backend=backend)
        X, y = make_tpm_like(n_cells=n, n_genes=n_genes, n_types=n_types, seed=0)
        if name == "wang_479x20000":
            sharp_tpu_torch.sharp(X, device=dev, **kw)  # warm-up: CUDA context, cuBLAS
        res, wall, counts, _, routes = _run_counted(X, device=dev, **kw)
        score = ari(y, res.pred_clusters)
        stages = _stages(res)
        print(
            f"[slice] {name}: {res.N_pred_cluster} clusters, ARI {score:.4f}, "
            f"per-member k {res.per_member_k.tolist()}, wall {wall:.3f} s, "
            f"launches {counts}, routes {routes}",
            flush=True,
        )
        print(f"[slice] {name} stages (s): {json.dumps(stages)}", flush=True)
        if score < 0.9:
            raise AssertionError(f"{name}: ARI {score:.4f} < 0.9")
        # one block linkage, one wMetaC meta linkage, two testlog probes: by
        # serial Ward up to n_pad 1024, by the ladder above
        ladder = n > 1024
        if (counts["rnn_tail"] if ladder else counts["ward_serial"]) < (1 if ladder else 4) or (
            counts["ward_serial"] < 1 or counts["cutree"] < (2 if ladder else 4)
        ):
            raise AssertionError(f"{name}: the kernels were not launched on every linkage: {counts}")
        out[name] = dict(
            n_cells=n, n_genes=n_genes, linkage_backend=backend, clusters=res.N_pred_cluster, ari=score,
            wall_s=wall, stages=stages, launches=counts, routes=routes,
            per_member_k=res.per_member_k.tolist(),
        )
        if name.startswith("wang") or ladder:
            cfg = resolve_config(n, X.shape[1], **SEED_KW)
            genes = preprocess(X, cfg).shape[1]
            K, p = cfg.ensize_K, cfg.reduced_ndim
            rng = np.random.default_rng(2103)
            R = carry.rp_from_jax(_ternary(rng, genes, K * p), K, p)
            probe = carry.testlog_probe_from_jax(rng.permutation(n), _ternary(rng, genes, p), n, genes, p)
            blocks = {}
            real_cut = linkage_cuda.cutree_snapshots_kernel

            def spy(merges, n_real, **k):
                # the block linkage's merges: the one cut replay of K problems
                if merges.shape[0] == K and "merges" not in blocks:
                    blocks.update(merges=merges.clone(), n_real=n_real, **k)
                return real_cut(merges, n_real, **k)

            linkage_cuda.cutree_snapshots_kernel = spy
            try:
                on_card = sharp_tpu_torch.sharp(X, rM=R, testlog_probe=probe, device=dev, **kw)
            finally:
                linkage_cuda.cutree_snapshots_kernel = real_cut
            t0 = time.perf_counter()
            on_cpu = sharp_tpu_torch.sharp(X, rM=R, testlog_probe=probe, device="cpu", **kw)
            cpu_wall = time.perf_counter() - t0
            same = np.array_equal(on_card.pred_clusters, on_cpu.pred_clusters) and np.array_equal(
                on_card.per_member_k, on_cpu.per_member_k
            )
            print(
                f"[slice] {name} card vs CPU with injected draws: labels and per-member k "
                f"{'identical' if same else 'DIFFER'} (card k {on_card.per_member_k.tolist()}, "
                f"cpu k {on_cpu.per_member_k.tolist()}, ARI card/cpu "
                f"{ari(on_card.pred_clusters, on_cpu.pred_clusters):.4f}); CPU run {cpu_wall:.3f} s",
                flush=True,
            )
            if not same:
                raise AssertionError(f"{name}: the card and the CPU disagree with the same draws")
            out[name]["cpu_wall_s"] = cpu_wall
            if ladder:
                merges = blocks["merges"]
                G, n_pad = merges.shape[0], merges.shape[1] + 1
                nr = counts_per_problem(blocks["n_real"], G, "cpu").tolist()
                row = _hold_cutree(f"cutree_{G}x{n_pad}", merges, nr, blocks["ncand"], blocks["minN"])
                row["shape"] = [G, n_pad]
                record.setdefault("kernels", {})[f"cutree_{G}x{n_pad}"] = row
                print(
                    f"[kernels] cutree_{G}x{n_pad} on {name}'s block merges: identical to the plain "
                    f"replay; {row['cutree_ms']:.3f} ms (plain {row['cutree_plain_ms']:.3f} ms, bound "
                    f"{row['cutree_bound_ms'] * 1e3:.2f} us)",
                    flush=True,
                )
    record["slice"] = out


def _timed_parts(torch):
    """Wrap the large tier's parts in synchronised host timers: the fold
    program per group (the rest of fold_ensemble is the host staging of the
    group and its copy to the card) and, inside it, the projection, the
    distances, the block linkage call, the cut replay, the selection of all
    the group's members (one select_cut) and its wMetaC (one call)."""
    from sharp_tpu_torch.core import block, fold
    from sharp_tpu_torch.parallel import sharded

    acc = {}
    saved = []
    for mod, name in (
        (sharded, "fold_program"), (block, "rp_project_ensemble"), (block, "prep_distance"),
        (block, "linkage"), (block, "cutree_multi_kernel"), (block, "select_cut"), (fold, "wmetac"),
    ):
        real = getattr(mod, name)

        def wrapper(*a, _real=real, _name=name, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _real(*a, **k)
            torch.cuda.synchronize()
            acc[_name] = acc.get(_name, 0.0) + time.perf_counter() - t
            return out

        setattr(mod, name, wrapper)
        saved.append((mod, name, real))
    return acc, saved


def _host_reads(torch, fn):
    """fn() under torch.profiler (host activity only): its result and the
    reads of device values by the host it made, counted as the profiler's
    aten::_local_scalar_dense events (the op behind .item(), int(), bool()
    and indexing by a 0-d tensor), and its nonzero calls (a sync on the
    card)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ev = {e.key: e.count for e in prof.key_averages()}
    return out, {"host_reads": ev.get("aten::_local_scalar_dense", 0), "nonzero": ev.get("aten::nonzero", 0)}


def _parts_and_reads(torch, phase, name, run, wall_key):
    """Two more calls of run() (-> a result with stages): one with the fold
    program's parts synchronised and timed (`_timed_parts`), one under the
    profiler counting its host reads. Returns their record."""
    acc, saved = _timed_parts(torch)
    try:
        res, wall = run()
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    fe = _stages(res)[wall_key]
    parts = {k: dict(seconds=v, share_of_stage=v / fe) for k, v in acc.items()}
    print(
        f"[{phase}] {name} parts, synchronised ({wall_key} {fe:.3f} s, wall {wall:.3f} s): "
        + ", ".join(f"{k} {v['seconds']:.3f} s ({100 * v['share_of_stage']:.1f}%)" for k, v in parts.items()),
        flush=True,
    )
    (_, reads_wall), reads = _host_reads(torch, run)
    print(f"[{phase}] {name} host reads of one call (torch.profiler): {reads}; that call's wall "
          f"{reads_wall:.3f} s under the profiler", flush=True)
    return dict(stage_s=fe, wall_s=wall, parts=parts, profiled_wall_s=reads_wall, **reads)


def _large_a_input(ensize_K=None):
    """Phase 5 (a)'s 6,000 x 5,000 input and its numpy-made draws (the RP
    matrices, the testlog probe, the cell reshuffle); with `ensize_K`, the
    first ensize_K members of the same RP matrices."""
    from sharp_tpu_torch import carry
    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch.core.pipeline import preprocess
    from synth import make_tpm_like

    n = 6000
    X, y = make_tpm_like(n_cells=n, n_genes=5000, n_types=10, seed=0)
    cfg = resolve_config(n, X.shape[1], **SEED_KW)
    genes = preprocess(X, cfg).shape[1]
    K, p = cfg.ensize_K, cfg.reduced_ndim
    rng = np.random.default_rng(6000)
    R = _ternary(rng, genes, K * p)
    k = ensize_K or K
    draws = dict(
        rM=carry.rp_from_jax(R[:, : k * p], k, p),
        testlog_probe=carry.testlog_probe_from_jax(rng.permutation(n), _ternary(rng, genes, p), n, genes, p),
        shuffle_perm=carry.shuffle_perm_from_jax(rng.permutation(n), n),
    )
    return X, y, draws


def _watch_fold_groups(fn):
    """fn() with each fold-program call of the large tier's fold pass
    watched -> (fn's result, per call: its lanes, the ladder levels of its
    round launches, their number, and its launches and problems by
    kernel)."""
    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.parallel import sharded

    calls, levels = [], [None]
    real_round, real_program = linkage_cuda.rnn_round_kernel, sharded.fold_program

    def round_spy(ladder, *a):
        if levels[0] is not None:
            levels[0].append(ladder.D.shape[-1])
        return real_round(ladder, *a)

    def program_spy(Xg, *a, **k):
        levels[0] = []
        launches, problems = dict(linkage_cuda.LAUNCHES), dict(linkage_cuda.PROBLEMS)
        try:
            return real_program(Xg, *a, **k)
        finally:
            calls.append(dict(
                lanes=int(Xg.shape[0]), levels=sorted(set(levels[0])), rounds=len(levels[0]),
                launches={k: n - launches[k] for k, n in linkage_cuda.LAUNCHES.items()},
                problems={k: n - problems[k] for k, n in linkage_cuda.PROBLEMS.items()},
            ))
            levels[0] = None

    linkage_cuda.rnn_round_kernel, sharded.fold_program = round_spy, program_spy
    try:
        return fn(), calls
    finally:
        linkage_cuda.rnn_round_kernel, sharded.fold_program = real_round, real_program


def phase_large(dev, record, Xbig, ybig):
    import torch

    from sharp_tpu_torch.analysis.ari import ari
    from sharp_tpu_torch.core.large import fold_sizes

    import sharp_tpu_torch

    out = {}
    # (a) card vs CPU with the same draws; also the warm-up of the large tier
    X, y, draws = _large_a_input()
    on_card, wall, counts, _, _ = _run_counted(X, device=dev, **draws, **SEED_KW)
    t0 = time.perf_counter()
    on_cpu = sharp_tpu_torch.sharp(X, device="cpu", **draws, **SEED_KW)
    cpu_wall = time.perf_counter() - t0
    same = (
        np.array_equal(on_card.pred_clusters, on_cpu.pred_clusters)
        and np.array_equal(on_card.per_member_k, on_cpu.per_member_k)
        and np.array_equal(on_card.folds, on_cpu.folds)
    )
    print(
        f"[large] cells_6000x5000 card vs CPU with injected draws: labels, per-member k and folds "
        f"{'identical' if same else 'DIFFER'} ({on_card.N_pred_cluster} clusters, ARI vs types "
        f"{ari(y, on_card.pred_clusters):.4f}, card/cpu ARI {ari(on_card.pred_clusters, on_cpu.pred_clusters):.4f}); "
        f"card {wall:.3f} s, CPU {cpu_wall:.3f} s, launches {counts}",
        flush=True,
    )
    if not same:
        raise AssertionError("cells_6000x5000: the card and the CPU disagree with the same draws")
    if min(counts.values()) < 1:
        raise AssertionError(f"cells_6000x5000: a kernel was not launched: {counts}")
    out["cells_6000x5000"] = dict(
        wall_s=wall, cpu_wall_s=cpu_wall, launches=counts, stages=_stages(on_card),
        clusters=on_card.N_pred_cluster, ari=ari(y, on_card.pred_clusters),
    )

    # (b) the flagship block
    T = len(fold_sizes(len(ybig), FOLD))
    runs = {}
    groups = math.ceil(T / GROUP)
    for backend in ("auto", "rnn_bf16"):
        (res, wall, counts, problems, routes), calls = _watch_fold_groups(
            lambda: _run_counted(Xbig, device=dev, linkage_backend=backend, **SEED_KW))
        score = ari(ybig, res.pred_clusters)
        stages = _stages(res)
        runs[backend] = dict(
            wall_s=wall, ari=score, clusters=res.N_pred_cluster, stages=stages, launches=counts,
            problems=problems, routes=routes,
        )
        print(
            f"[large] flagship_50000x27998 linkage_backend={backend}: {res.N_pred_cluster} clusters, "
            f"ARI {score:.4f}, {T} folds, wall {wall:.3f} s, launches {counts}, problems {problems}, "
            f"routes {routes}",
            flush=True,
        )
        print(f"[large] flagship_50000x27998 {backend} stages (s): {json.dumps(stages)}", flush=True)
        if backend == "auto":
            main_counts, main_res = counts, res
            if score < 0.9:
                raise AssertionError(f"flagship: ARI {score:.4f} < 0.9")
            if counts["rnn_tail"] < groups:
                raise AssertionError(f"flagship: the tail kernel ran {counts['rnn_tail']} times "
                                     f"for at least {groups} fold groups")
            # three ladder levels (2048, 1024, 512) of at least one round each
            if counts["rnn_round"] < 3 * groups:
                raise AssertionError(f"flagship: the round kernel ran {counts['rnn_round']} times "
                                     f"for {groups} fold groups of 3 levels")
            # serial Ward: every fold's wMetaC problem and sMetaC's, in at
            # most one wMetaC launch per fold group and one for sMetaC;
            # every linkage its cut replay
            if problems["ward_serial"] < T + 1 or counts["ward_serial"] > groups + 1:
                raise AssertionError(f"flagship: serial Ward took {problems['ward_serial']} problems (>= {T + 1}) "
                                     f"in {counts['ward_serial']} launches (<= {groups + 1}): {counts}")
            if counts["cutree"] < counts["ward_serial"] + counts["rnn_tail"]:
                raise AssertionError(f"flagship: a linkage went without its cut replay: {counts}")
            if routes["cutree"]["serial"]:
                raise AssertionError(f"flagship: cut-replay problems took the serial route: {routes}")
            # every selection through the sweep's three kernels, one launch each
            sweep = routes["sweep"]
            if min(sweep.values()) < 1 or len(set(sweep.values())) != 1:
                raise AssertionError(f"flagship: the selection sweep's kernels launched {sweep}")
            # each fold group: rounds at the three levels, one tail, one
            # serial Ward launch for its lanes' wMetaC problems, a cut
            # replay per linkage
            print(f"[large] flagship_50000x27998 fold groups (lanes, levels, rounds): "
                  f"{[(c['lanes'], c['levels'], c['rounds']) for c in calls]}", flush=True)
            if not calls:
                raise AssertionError("flagship: no fold-program call was seen")
            for g, c in enumerate(calls):
                lc, pc = c["launches"], c["problems"]
                if (c["levels"] != [512, 1024, 2048] or lc["rnn_round"] != c["rounds"] or lc["rnn_tail"] != 1
                        or lc["ward_serial"] != 1 or pc["ward_serial"] != c["lanes"]
                        or lc["cutree"] < lc["ward_serial"] + lc["rnn_tail"]):
                    raise AssertionError(f"flagship: fold group {g} did not launch its kernels as it should: {c}")
            runs[backend]["fold_groups"] = calls

    # (c) two more f32 runs: the fold program's parts timed, and the host
    # reads of one call
    runs["parts"] = _parts_and_reads(torch, "large", "flagship", lambda: _run_counted(Xbig, device=dev, **SEED_KW)[:2],
                                     "fold_ensemble")
    out["flagship_50000x27998"] = runs
    record["large"] = out
    return main_counts, main_res


# --- the analysis layer --------------------------------------------------------
MARKER_CUT = (4096, 2048)   # cells, genes of the card-against-CPU marker check
# the card against the CPU after 10 t-SNE iterations from one start layout,
# within tests/test_torch_analysis.py's TSNE_TOL of the largest coordinate
TSNE_CHECK_N, TSNE_CHECK_ITERS, TSNE_TOL = 500, 10, 1e-2


def _synced(torch, fn):
    """fn() and its wall seconds, the card synchronised before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _analysis_gethclust(dev, out):
    """(a) gethclust on a Pearson d of log2 expression and its features, at
    n 479 (n_pad 512) and 1,000 (1024), on the card and on the CPU. Returns
    the launches of the two card calls."""
    import torch

    import sharp_tpu_torch
    from sharp_tpu_torch.analysis.ari import ari
    from sharp_tpu_torch.config import pad_dim
    from sharp_tpu_torch.ops import linkage_cuda
    from synth import make_tpm_like

    problems = []
    for n in (479, 1000):
        X, y = make_tpm_like(n_cells=n, n_genes=20000, n_types=7, seed=0)
        Z = np.log2(1.0 + X).astype(np.float32)
        problems.append((n, y, (1.0 - np.corrcoef(Z)).astype(np.float32), Z))
    linkage_cuda.LAUNCHES.update(dict.fromkeys(linkage_cuda.LAUNCHES, 0))
    cards = [sharp_tpu_torch.gethclust(d, Z, device=dev) for _, _, d, Z in problems]
    torch.cuda.synchronize()
    counts = dict(linkage_cuda.LAUNCHES)
    if counts["ward_serial"] < 2 or counts["cutree"] < 2:
        raise AssertionError(f"gethclust: serial Ward or the cut replay was not launched: {counts}")
    for (n, y, d, Z), card in zip(problems, cards):
        t = time.perf_counter()
        cpu = sharp_tpu_torch.gethclust(d, Z, device="cpu")
        cpu_s = time.perf_counter() - t
        walls = [_synced(torch, lambda: sharp_tpu_torch.gethclust(d, Z, device=dev))[1] for _ in range(3)]
        same = {k: bool(np.array_equal(card[k], cpu[k])) for k in ("f", "msil", "CHind", "height")}
        same["oind"] = card["oind"] == cpu["oind"]
        msil_err = float(np.abs(card["msil"] - cpu["msil"]).max())
        ch_rel = float((np.abs(card["CHind"] - cpu["CHind"]) / np.maximum(np.abs(cpu["CHind"]), 1e-30)).max())
        row = dict(
            n=n, n_pad=pad_dim(n), identical=same,
            msil_max_abs_diff=msil_err, ch_max_rel_diff=ch_rel, ari=ari(y, card["f"]),
            clusters=int(card["f"].max()), card_s=float(np.median(walls)), cpu_s=cpu_s,
        )
        print(f"[analysis] gethclust n={n}: {row}", flush=True)
        if not (same["f"] and same["height"] and same["oind"]):
            raise AssertionError(f"gethclust n={n}: labels, heights or the chosen cut differ card/CPU: {same}")
        if msil_err > 1e-6 or ch_rel > 1e-4:
            raise AssertionError(f"gethclust n={n}: msil {msil_err} (<= 1e-6) or CH {ch_rel} (<= 1e-4 rel)")
        out[f"gethclust_{n}"] = row
    out["gethclust_launches"] = counts
    out["gethclust_8300"] = _gethclust_above_8192(dev)
    return counts


def _gethclust_above_8192(dev):
    """gethclust at 8,300 points (n_pad 8704, above the old cap of 8192) on
    the card: its linkage, serial Ward with the row state in the global
    scratch, identical to the plain loop on the same padded matrix; the
    heights returned are its first n - 1. One call, timed."""
    import torch

    import sharp_tpu_torch
    from sharp_tpu_torch.ops import select
    from sharp_tpu_torch.ops.linkage import ward_linkage

    n = 8300
    rng = np.random.default_rng(n)
    y = rng.integers(0, 6, n)
    X = (3.0 * np.eye(6)[y] @ rng.normal(size=(6, 20)) + 0.5 * rng.normal(size=(n, 20))).astype(np.float32)
    d = (1.0 - np.corrcoef(X)).astype(np.float32)
    seen = {}
    real = select.linkage

    def spy(D, backend, method):
        out = real(D, backend, method)
        seen.update(D=D, out=out)
        return out

    select.linkage = spy
    try:
        got, card_s = _synced(torch, lambda: sharp_tpu_torch.gethclust(d, X, device=dev))
    finally:
        select.linkage = real
    ref = ward_linkage(seen["D"])
    same = bool(torch.equal(seen["out"].merges, ref.merges) and torch.equal(seen["out"].heights, ref.heights)
                and np.array_equal(got["height"], ref.heights.cpu().numpy()[: n - 1]))
    row = dict(n=n, n_pad=int(seen["D"].shape[-1]), card_s=card_s, clusters=int(got["f"].max()),
               linkage_identical_to_plain=same)
    print(f"[analysis] gethclust n={n}: {row}", flush=True)
    if not same or not 2 <= row["clusters"] <= 40:
        raise AssertionError(f"gethclust n={n}: {row}")
    del seen, ref
    torch.cuda.empty_cache()
    return row


def _analysis_markers(dev, out, Xbig, labels):
    """(b) marker genes on the flagship block with sharp()'s labels."""
    import torch

    from sharp_tpu_torch.analysis import markers as mk

    # the card against the CPU on a cut
    nc, gc = MARKER_CUT
    Xc = np.ascontiguousarray(Xbig[:nc, :gc])
    stats = {}
    for where in (dev, "cpu"):
        _, _, C, oh, counts = mk._label_encoding(labels[:nc], where)
        stats[str(where)] = [x.cpu() for x in mk._gene_chunk_stats(
            torch.from_numpy(Xc).to(where), oh, counts, C=C)]
    card, cpu = stats[str(dev)], stats["cpu"]
    names = ("dp", "best", "auc", "z", "fc")
    same = {k: bool(torch.equal(a, b)) for k, a, b in zip(names, card, cpu)}
    rel = {k: float(((a.double() - b.double()).abs() / b.double().abs().clamp_min(1e-30)).max())
           for k, a, b in zip(names[3:], card[3:], cpu[3:])}
    print(f"[analysis] markers cut {nc} x {gc}, card vs CPU: identical {same}, max rel diff {rel}", flush=True)
    if not (same["dp"] and same["best"] and same["auc"]) or max(rel.values()) > 1e-5:
        raise AssertionError(f"markers cut: card and CPU disagree: {same}, {rel}")
    out["markers_cut"] = dict(shape=[nc, gc], identical=same, max_rel_diff=rel)

    # the whole block: the call, twice; four row blocks; unlimited2 over
    # four gene slices against get_marker_genes at its thresholds
    n, G = Xbig.shape
    full, wall = _synced(torch, lambda: mk.get_marker_genes(Xbig, labels, device=dev))
    again, wall2 = _synced(torch, lambda: mk.get_marker_genes(Xbig, labels, device=dev))
    rows = np.array_split(np.arange(n), 4)
    blocked, wall_b = _synced(torch, lambda: mk.get_marker_genes([Xbig[r[0]:r[-1] + 1] for r in rows], labels,
                                                                  device=dev))
    cols = np.array_split(np.arange(G), 4)
    slices = [Xbig[:, c[0]:c[-1] + 1] for c in cols]
    unl, wall_u = _synced(torch, lambda: mk.get_marker_genes_unlimited2(slices, labels, ng=1, device=dev))
    at_thr = mk.get_marker_genes(Xbig, labels, theta=1e-5, auc_thre=0.85, p_thre=0.05, device=dev)

    def same_result(a, b):
        return all(np.array_equal(a.gallinfo[k], b.gallinfo[k]) for k in a.gallinfo) and all(
            np.array_equal(a.mginfo[k], b.mginfo[k]) for k in a.mginfo) and np.array_equal(a.mat, b.mat)

    checks = dict(
        repeat_identical=same_result(full, again),
        blocked_identical=all(np.array_equal(full.mginfo[k], blocked.mginfo[k]) for k in full.mginfo)
        and np.array_equal(full.mat, blocked.mat),
        every_cluster_keeps_a_marker=set(np.unique(full.mginfo["cluster"])) == set(np.unique(labels)),
        unlimited2_ng1_same_genes=bool(np.array_equal(unl.mginfo["gene_index"], at_thr.mginfo["gene_index"])),
    )
    # the parts of one call: the host's column slices, their copies to the
    # card, and the card's statistics on chunks already there
    starts = range(0, G, 2048)
    t = time.perf_counter()
    host = [np.ascontiguousarray(Xbig[:, s:s + 2048], np.float32) for s in starts]
    slice_s = time.perf_counter() - t
    on_card, upload_s = _synced(torch, lambda: [torch.from_numpy(h).to(dev) for h in host])
    del host
    _, _, C, oh, counts = mk._label_encoding(labels, dev)
    _, stats_s = _synced(torch, lambda: [mk._gene_chunk_stats(x, oh, counts, C=C) for x in on_card])
    del on_card
    torch.cuda.empty_cache()
    row = dict(
        shape=[n, G], chunks=len(starts), markers=full.n_markers, adauc=full.adauc, **checks,
        wall_s=wall, wall_repeat_s=wall2, wall_blocked_s=wall_b, wall_unlimited2_s=wall_u,
        host_slice_s=slice_s, upload_s=upload_s, card_stats_s=stats_s,
        unlimited2_markers=unl.n_markers,
    )
    print(f"[analysis] markers {n} x {G}: {row}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"markers on the flagship block: {checks}")
    out["markers_flagship"] = row


def _analysis_embedding(dev, out, res):
    """(c) the embedding of the flagship result: a 10,000-cell subsample,
    PCA to 50, 500 t-SNE iterations on the card."""
    import torch

    from sharp_tpu_torch.analysis import embed

    (emb, idx), wall = _synced(torch, lambda: embed.visualization_embedding(res, device=dev))
    lab = res.pred_clusters[idx]
    cl = np.unique(lab)
    cent = np.stack([emb[lab == c].mean(0) for c in cl])
    within = float(np.mean([np.mean(np.linalg.norm(emb[lab == c] - cent[i], axis=1)) for i, c in enumerate(cl)]))
    between = float(np.mean([np.linalg.norm(cent[a] - cent[b]) for a in range(len(cl)) for b in range(a + 1, len(cl))]))
    # the parts: host input (z-score, subsample, PCA), the joint P, the loop
    t = time.perf_counter()
    X, idx2 = embed.embedding_input(res)
    host_s = time.perf_counter() - t
    Xt = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
    _, p_s = _synced(torch, lambda: embed._joint_p(Xt, 30.0))
    Y0 = embed.initial_layout(len(idx2), 10).to(dev)
    _, tsne_s = _synced(torch, lambda: embed._tsne_exact(Xt, Y0))
    del Xt
    torch.cuda.empty_cache()
    # the card against the CPU from one start layout
    Xs, _ = embed.embedding_input(res, max_cells=TSNE_CHECK_N)
    Xs = torch.from_numpy(np.ascontiguousarray(Xs, np.float32))
    Ys = embed.initial_layout(Xs.shape[0], 3)
    a = embed._tsne_exact(Xs.to(dev), Ys.to(dev), n_iter=TSNE_CHECK_ITERS).cpu()
    b = embed._tsne_exact(Xs, Ys, n_iter=TSNE_CHECK_ITERS)
    diff = float((a - b).abs().max() / b.abs().max())
    row = dict(
        cells=len(idx), finite=bool(np.all(np.isfinite(emb))), between=between, within=within,
        wall_s=wall, host_input_s=host_s, joint_p_s=p_s, tsne_s=tsne_s,
        ms_per_iteration=1e3 * (tsne_s - p_s) / 500, card_vs_cpu_n=int(Xs.shape[0]),
        card_vs_cpu_rel_max_diff=diff, same_subsample=bool(np.array_equal(idx, idx2)),
    )
    print(f"[analysis] embedding: {row}", flush=True)
    if not (row["finite"] and emb.shape == (len(idx), 2) and len(idx) <= 10000 and row["same_subsample"]):
        raise AssertionError(f"embedding: {row}")
    if between <= 3 * within:
        raise AssertionError(f"embedding: between-cluster {between} <= 3 x within-cluster {within}")
    if diff > TSNE_TOL:
        raise AssertionError(f"embedding: card and CPU differ by {diff} of the layout after "
                             f"{TSNE_CHECK_ITERS} iterations (<= {TSNE_TOL})")
    out["embedding"] = row


def _analysis_cli(out, tmp):
    """(d) python -m sharp_tpu_torch cluster, markers, embed in subprocesses
    with the default device, on 479 x 20,000."""
    from sharp_tpu_torch.analysis.ari import ari
    from synth import make_tpm_like

    X, y = make_tpm_like(n_cells=479, n_genes=20000, n_types=7, seed=0)
    xpath = os.path.join(tmp, "X.npz")
    np.savez(xpath, X=X, gene_names=np.array([f"G{i}" for i in range(X.shape[1])]))
    paths = {k: os.path.join(tmp, f"{k}.npz") for k in ("res", "markers", "emb")}
    env = dict(os.environ, PYTHONPATH=HERE)
    walls = {}
    for cmd, args in (
        ("cluster", [xpath, "--out", paths["res"], "--rN-seed", "2103", "--exp-type", "TPM"]),
        ("markers", [xpath, paths["res"], "--out", paths["markers"]]),
        ("embed", [paths["res"], "--out", paths["emb"]]),
    ):
        t = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "sharp_tpu_torch", cmd, *args], cwd=tmp, env=env,
                             capture_output=True, text=True, timeout=300)
        walls[cmd] = time.perf_counter() - t
        if run.returncode != 0:
            raise AssertionError(f"cli {cmd} exited {run.returncode}: {run.stderr[-2000:]}")
        print(f"[analysis] cli {cmd}: {run.stdout.strip().splitlines()[-1]} ({walls[cmd]:.1f} s)", flush=True)
    want = {
        "res": {"pred_clusters", "x0", "viE", "paras", "timing"},
        "markers": {"mg_gene", "mg_gene_index", "mg_cluster", "mg_sparsity", "mg_auc", "mg_pvalue",
                    "mg_p_adj", "mg_fold_change"},
        "emb": {"embedding", "cell_indices"},
    }
    for k, keys in want.items():
        with np.load(paths[k], allow_pickle=True) as z:
            if set(z.files) != keys:
                raise AssertionError(f"cli {k}: keys {sorted(z.files)}, the JAX CLI writes {sorted(keys)}")
            if k == "res":
                score = ari(y, z["pred_clusters"])
            if k == "emb" and not np.all(np.isfinite(z["embedding"])):
                raise AssertionError("cli embed: the embedding is not finite")
    if score < 0.9:
        raise AssertionError(f"cli cluster: ARI {score:.4f} < 0.9")
    out["cli"] = dict(ari=score, walls_s=walls)


def phase_analysis(dev, record, Xbig, flagship):
    """Phase 7: gethclust, the marker genes, the embedding and the CLI on
    the card. Returns the kernels' launches of the gethclust calls."""
    out = {}
    t0 = time.perf_counter()
    counts = _analysis_gethclust(dev, out)
    _analysis_markers(dev, out, Xbig, flagship.pred_clusters)
    _analysis_embedding(dev, out, flagship)
    tmp = tempfile.mkdtemp(prefix="sharp_smoke_cli_")
    try:
        _analysis_cli(out, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[analysis] phase {out['phase_s']:.1f} s", flush=True)
    record["analysis"] = out
    return counts


# --- the streaming path ------------------------------------------------------
# The flagship dataset of the bench's API path: 50,000-cell blocks of 27,998
# genes, 38 planted types, 2,048 nonzero genes per cell (1,536 of the
# cell's type's top genes and a random tail), CPM-scaled; type means from
# seed 123, block b from seed 1000 + b. The generator is the bench's
# (`sharp_tpu_torch.io.benchdata`, which bench_torch.py uses too).
API_GENES, API_TYPES, API_KEEP, API_BLOCK, API_BLOCKS = 27998, 38, 2048, 50000, 4


def _script(name):
    """scripts/<name>.py as a module."""
    import importlib

    path = os.path.join(HERE, "scripts")
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def phase_unlimited(dev, record, tmp):
    """(a) 3 SBLK blocks of 2,500 x 5,000 on the card (sparse feed and host
    densify) and on the CPU with one injected RP matrix: identical labels.
    (b) The first 4 blocks of the flagship dataset through sharp_unlimited,
    as the bench's API path calls it, after an untimed warm-up on block 0
    declaring the same n_cells: ARI >= 0.95, <= 57 clusters, launches."""
    import torch

    import sharp_tpu_torch
    from sharp_tpu_torch.analysis.ari import ari
    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch.io import benchdata
    from sharp_tpu_torch.io.blocks import save_blocks
    from sharp_tpu_torch.parallel import streaming
    from synth import make_tpm_like

    out = {}
    # (a) card against CPU
    n, genes = 7500, 5000
    X, y = make_tpm_like(n_cells=n, n_genes=genes, n_types=10, seed=0)
    small = os.path.join(tmp, "small")
    save_blocks(small, [X[:2500], X[2500:5000], X[5000:]], fmt="sblk")
    kw = dict(rN_seed=2103, resume=False)
    cfg = resolve_config(n, genes, rN_seed=2103)
    R = _ternary(np.random.default_rng(7500), genes, cfg.ensize_K * cfg.reduced_ndim)
    real = _script("multihost_26block_torch").patched_rp(streaming, R)
    try:
        card, wall, counts, _, _ = _run_counted(small, entry="sharp_unlimited", device=dev, **kw)
        dense = sharp_tpu_torch.sharp_unlimited(small, device=dev, sparse_feed=False, **kw)
        t0 = time.perf_counter()
        cpu = sharp_tpu_torch.sharp_unlimited(small, device="cpu", **kw)
        cpu_wall = time.perf_counter() - t0
    finally:
        streaming.ensemble_rp_matrix = real
    same = np.array_equal(card.pred_clusters, cpu.pred_clusters)
    same_feed = np.array_equal(card.pred_clusters, dense.pred_clusters)
    print(
        f"[unlimited] 3 x 2,500 x 5,000 SBLK blocks, one injected RP matrix: card vs CPU labels "
        f"{'identical' if same else 'DIFFER'}, sparse feed vs host densify on the card "
        f"{'identical' if same_feed else 'DIFFER'} ({card.N_pred_cluster} clusters, ARI vs types "
        f"{ari(y, card.pred_clusters):.4f}); card {wall:.3f} s, CPU {cpu_wall:.3f} s, launches {counts}",
        flush=True,
    )
    if not (same and same_feed):
        raise AssertionError("unlimited (a): the card, the CPU and the two feeds disagree")
    if min(counts.values()) < 1:
        raise AssertionError(f"unlimited (a): a kernel was not launched: {counts}")
    out["blocks_3x2500x5000"] = dict(
        wall_s=wall, cpu_wall_s=cpu_wall, launches=counts, clusters=card.N_pred_cluster,
        ari=ari(y, card.pred_clusters), stages=_stages(card),
    )
    shutil.rmtree(small)

    # (b) the first 4 blocks of the flagship dataset, full width
    t0 = time.perf_counter()
    data = os.path.join(tmp, "flagship")
    warm = os.path.join(tmp, "warm")
    os.makedirs(data)
    os.makedirs(warm)
    benchdata.make_blocks(data, [API_BLOCK] * API_BLOCKS, API_GENES, API_TYPES, API_KEEP)
    n_cells = API_BLOCK * API_BLOCKS
    with open(os.path.join(data, "blocks.json"), "w") as fh:
        json.dump({"n_cells": n_cells, "n_genes": API_GENES, "n_blocks": API_BLOCKS}, fh)
    os.symlink(os.path.join(data, "block_00000.sblk"), os.path.join(warm, "block_00000.sblk"))
    y = np.concatenate([benchdata.block_y(bi, API_BLOCK, API_TYPES) for bi in range(API_BLOCKS)])
    gen_s = time.perf_counter() - t0
    sblk_bytes = sum(os.path.getsize(os.path.join(data, f)) for f in os.listdir(data))
    print(f"[unlimited] flagship blocks: {API_BLOCKS} x {API_BLOCK} x {API_GENES}, "
          f"{sblk_bytes / 1e9:.3f} GB of SBLK, made in {gen_s:.1f} s", flush=True)
    api_kw = dict(
        rN_seed=7, ensize_K=5, reduced_ndim=256, partition_ncells=2000,
        dtype_compute="bfloat16", forview=False, resume=False, device=dev,
    )
    t0 = time.perf_counter()
    sharp_tpu_torch.sharp_unlimited(warm, n_cells=n_cells, manifest_dir=None, **api_kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    res, wall, counts, problems, routes = _run_counted(data, entry="sharp_unlimited", **api_kw)
    score = ari(y, res.pred_clusters)
    stages = _stages(res)
    T = math.ceil(API_BLOCK / 2000)          # folds per block
    groups = API_BLOCKS * math.ceil(T / GROUP)
    print(
        f"[unlimited] flagship 4 blocks ({n_cells} cells): {res.N_pred_cluster} clusters, ARI "
        f"{score:.4f}; wall {wall:.3f} s (warm-up on block 0 {warm_s:.3f} s), {n_cells / wall:.1f} "
        f"cells/s; launches {counts}; problems {problems}; routes {routes}",
        flush=True,
    )
    print(f"[unlimited] flagship stages (s): {json.dumps(stages)}", flush=True)
    if score < 0.95 or res.N_pred_cluster > math.ceil(1.5 * API_TYPES):
        raise AssertionError(f"unlimited (b): ARI {score:.4f} (>= 0.95), {res.N_pred_cluster} "
                             f"clusters (<= {math.ceil(1.5 * API_TYPES)})")
    # per fold group: 3 ladder levels and one tail; one wMetaC per fold;
    # a cut replay per linkage
    if counts["rnn_round"] < 3 * groups or counts["rnn_tail"] < groups:
        raise AssertionError(f"unlimited (b): the ladder kernels ran too few times for {groups} "
                             f"fold groups: {counts}")
    # serial Ward: every fold's wMetaC problem, in at most one wMetaC launch
    # per fold group; the per-block fuses (a launch per shape bucket) and the
    # global fuse add at most API_BLOCKS + 1
    if problems["ward_serial"] < API_BLOCKS * T or counts["ward_serial"] > groups + API_BLOCKS + 1:
        raise AssertionError(f"unlimited (b): serial Ward took {problems['ward_serial']} problems (>= "
                             f"{API_BLOCKS * T} folds) in {counts['ward_serial']} launches (<= "
                             f"{groups + API_BLOCKS + 1}): {counts}")
    if counts["cutree"] < counts["ward_serial"] + counts["rnn_tail"]:
        raise AssertionError(f"unlimited (b): a linkage went without its cut replay: {counts}")
    if routes["cutree"]["serial"]:
        raise AssertionError(f"unlimited (b): cut-replay problems took the serial route: {routes}")
    # bf16 RP operands: every fold group's product on the tensor cores, one
    # operand kernel launch each
    if routes["rp"]["tensor_core"] != groups:
        raise AssertionError(f"unlimited (b): {routes['rp']['tensor_core']} RP products on the tensor cores "
                             f"for {groups} fold groups: {routes}")
    out["flagship_4x50000x27998"] = dict(
        n_cells=n_cells, wall_s=wall, warm_s=warm_s, cells_per_s=n_cells / wall, ari=score,
        clusters=res.N_pred_cluster, stages=stages, launches=counts, problems=problems, routes=routes,
        fold_groups=groups, sblk_bytes=sblk_bytes, datagen_s=gen_s,
        parts=_parts_and_reads(
            torch, "unlimited", "flagship 4 blocks",
            lambda: _run_counted(data, entry="sharp_unlimited", **api_kw)[:2], "block_pass",
        ),
    )
    record["unlimited"] = out
    return counts, problems, dict(dir=data, labels=res.pred_clusters, clusters=res.N_pred_cluster, y=y, wall_s=wall,
                        knobs=api_kw)


# --- the parallel paths ---------------------------------------------------------


def _same_result(a, b):
    return (np.array_equal(a.pred_clusters, b.pred_clusters) and np.array_equal(a.per_member_k, b.per_member_k)
            and np.array_equal(a.folds, b.folds))


def _gate_launches(label, c, p, folds, groups, fuses=0):
    """Every kernel in one shard's or one process's launch counts `c` and
    problem counts `p`: per fold group the tail kernel once and the round
    kernel at its 3 ladder levels; serial Ward on the wMetaC problems of
    all `folds` folds (0 on an ens shard that runs no wMetaC) in at most one
    launch per fold group, plus at most `fuses` sMetaC launches; a cut
    replay per linkage."""
    if c is None or p is None or c["rnn_tail"] < groups or c["rnn_round"] < 3 * c["rnn_tail"] or (
        p["ward_serial"] < folds or c["ward_serial"] > groups + fuses
        or c["cutree"] < c["ward_serial"] + c["rnn_tail"]
    ):
        raise AssertionError(f"parallel {label} (wMetaC of {folds} folds, >= {groups} fold groups, <= {fuses} "
                             f"fuses) did not launch every kernel as it should: launches {c}, problems {p}")


def _gate_shards(label, shards, shard_problems, T, n_data, n_ens):
    """_gate_launches on every shard of an (n_data, n_ens) mesh over T folds:
    data shard d's folds are block_slice(T, d, n_data); each of its ens
    shards runs the ladder of their groups, its first the folds' wMetaC
    (the fuse runs outside the shards)."""
    from sharp_tpu_torch.parallel.multihost import block_slice

    for d in range(n_data):
        folds = len(block_slice(T, d, n_data))
        for e in range(n_ens):
            key = f"{d},{e}"
            _gate_launches(f"{label} shard {key}", shards.get(key), shard_problems.get(key),
                           folds if e == 0 else 0, math.ceil(folds / GROUP))


def _by_shard(counter):
    return {f"{k[0]},{k[1]}": v for k, v in sorted(counter.items())}


def phase_parallel_folds(dev, record, Xbig, ybig, flagship):
    """Phase 8 (a) and (b): folds and ensemble members over two shards, both
    on this card. Returns the launches of (b), the flagship block."""
    import sharp_tpu_torch
    from sharp_tpu_torch.analysis.ari import ari
    from sharp_tpu_torch.core.large import fold_sizes
    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.parallel import sharded

    out = {}
    # (a) phase 5 (a)'s input and draws, three ways, on the card and the CPU
    X, y, d = _large_a_input()
    X4, _, d4 = _large_a_input(ensize_K=4)
    t0 = time.perf_counter()
    one = sharp_tpu_torch.sharp(X, device=dev, **d, **SEED_KW)
    runs = {
        "n_devices_2": (dict(n_devices=2), X, d, one),
        "ens_2x_k4": (dict(n_devices=2, ensemble_axis=2, ensize_K=4), X4, d4,
                      sharp_tpu_torch.sharp(X4, device=dev, ensize_K=4, **d4, **SEED_KW)),
    }
    rows = {}
    for name, (kw, Xr, dr, ref) in runs.items():
        card, wall, counts, _, _ = _run_counted(Xr, device=dev, **kw, **dr, **SEED_KW)
        shards, shard_problems = _by_shard(linkage_cuda.SHARD_LAUNCHES), _by_shard(linkage_cuda.SHARD_PROBLEMS)
        t = time.perf_counter()
        cpu = sharp_tpu_torch.sharp(Xr, device="cpu", **kw, **dr, **SEED_KW)
        cpu_s = time.perf_counter() - t
        rows[name] = dict(card_equals_one_device=_same_result(card, ref), cpu_equals_one_device=_same_result(cpu, ref),
                          clusters=card.N_pred_cluster, per_member_k=card.per_member_k.tolist(), wall_s=wall,
                          cpu_s=cpu_s, launches=counts, launches_by_shard=shards, problems_by_shard=shard_problems)
        print(f"[parallel] cells_6000x5000 {name} {kw}: {rows[name]}", flush=True)
        if not (rows[name]["card_equals_one_device"] and rows[name]["cpu_equals_one_device"]):
            raise AssertionError(f"parallel (a) {name}: labels, per-member k or folds differ from one device")
        n_ens = kw.get("ensemble_axis", 1)
        _gate_shards(f"(a) {name}", shards, shard_problems, len(card.per_member_k), kw["n_devices"] // n_ens, n_ens)
    rows["phase_s"] = time.perf_counter() - t0
    out["cells_6000x5000"] = rows

    # (b) the flagship block over two data shards, at full width; each
    # shard's fold pass timed on the host (it ends in the shard's readback)
    T = len(fold_sizes(len(ybig), FOLD))
    spans, real = [], sharded._fold_groups

    def timed(*a, **k):
        t = time.perf_counter()
        out = real(*a, **k)
        spans.append((t, time.perf_counter(), len(a[1])))
        return out

    sharded._fold_groups = timed
    try:
        t0 = time.perf_counter()
        res, wall, counts, problems, routes = _run_counted(Xbig, device=dev, n_devices=2, **SEED_KW)
    finally:
        sharded._fold_groups = real
    spans = [dict(folds=f, start_s=a - t0, end_s=e - t0, seconds=e - a) for a, e, f in sorted(spans)]
    shards, shard_problems = _by_shard(linkage_cuda.SHARD_LAUNCHES), _by_shard(linkage_cuda.SHARD_PROBLEMS)
    score = ari(ybig, res.pred_clusters)
    one_wall = record["large"]["flagship_50000x27998"]["auto"]["wall_s"]
    same = bool(np.array_equal(res.pred_clusters, flagship.pred_clusters))
    print(
        f"[parallel] flagship_50000x27998 n_devices=2: {res.N_pred_cluster} clusters, ARI {score:.4f}, labels "
        f"{'identical to' if same else 'DIFFER from'} phase 5 (b)'s; wall {wall:.3f} s (one device, phase 5 (b): "
        f"{one_wall:.3f} s); launches {counts}; by shard {shards}; problems by shard {shard_problems}; routes "
        f"{routes}; shards' fold passes {spans}",
        flush=True,
    )
    print(f"[parallel] flagship n_devices=2 stages (s): {json.dumps(_stages(res))}", flush=True)
    if not same or score < 0.9:
        raise AssertionError(f"parallel (b): labels identical {same}, ARI {score:.4f} (>= 0.9)")
    _gate_shards("(b)", shards, shard_problems, T, 2, 1)
    if routes["cutree"]["serial"]:
        raise AssertionError(f"parallel (b): cut-replay problems took the serial route: {routes}")
    out["flagship_50000x27998_n_devices_2"] = dict(
        wall_s=wall, one_device_wall_s=one_wall, ari=score, clusters=res.N_pred_cluster, labels_identical=same,
        launches=counts, problems=problems, launches_by_shard=shards, problems_by_shard=shard_problems,
        routes=routes, stages=_stages(res), shard_fold_passes=spans,
    )
    record["parallel"] = out
    return counts


# `python -m sharp_tpu_torch <argv>` that prints its kernels' launch and
# problem counts after the command, each on a line of its own
_CLI_COUNTED = (
    "import json, sys\n"
    "from sharp_tpu_torch.cli import main\n"
    "from sharp_tpu_torch.ops import linkage_cuda\n"
    "rc = main(sys.argv[1:])\n"
    "print('[launches] ' + json.dumps(linkage_cuda.LAUNCHES), flush=True)\n"
    "print('[problems] ' + json.dumps(linkage_cuda.PROBLEMS), flush=True)\n"
    "sys.exit(rc)\n"
)


def phase_parallel_processes(dev, record, flag6):
    """Phase 8 (c): two processes on this card, each running the CLI's
    `unlimited --multihost --no-resume` over phase 6 (b)'s SBLK directory
    with its knobs: their labels, concatenated, equal phase 6 (b)'s, and
    each process launched every kernel its two blocks' folds need."""
    import re
    import socket

    import torch

    from sharp_tpu_torch.analysis.ari import ari
    from sharp_tpu_torch.parallel.multihost import block_slice

    torch.cuda.empty_cache()   # the card's free memory, for the two processes
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    kn = flag6["knobs"]
    argv = ["--rN-seed", str(kn["rN_seed"]), "--ensize-K", str(kn["ensize_K"]),
            "--reduced-ndim", str(kn["reduced_ndim"]), "--partition-ncells", str(kn["partition_ncells"]),
            "--dtype-compute", kn["dtype_compute"], "--device", torch.device(kn["device"]).type,
            "--multihost", "--no-resume"]
    tmp = tempfile.mkdtemp(prefix="sharp_smoke_mh_")
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            env = dict(os.environ, PYTHONPATH=HERE, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CLI_COUNTED, "unlimited", flag6["dir"],
                 "--out", os.path.join(tmp, f"p{rank}.npz"), *argv],
                cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        outs = [pr.communicate(timeout=600) for pr in procs]
        wall = time.perf_counter() - t0
        for rank, (pr, (so, se)) in enumerate(zip(procs, outs)):
            if pr.returncode != 0:
                raise AssertionError(f"parallel (c): process {rank} exited {pr.returncode}: {se[-2000:]}")
        counts = [int(re.search(r"(\d+) clusters", so).group(1)) for so, _ in outs]
        launches = [json.loads(re.search(r"^\[launches\] (.*)$", so, re.M).group(1)) for so, _ in outs]
        problems = [json.loads(re.search(r"^\[problems\] (.*)$", so, re.M).group(1)) for so, _ in outs]
        # each process's sharp_unlimited call, without its start-up
        call_s = [float(re.search(r"total time: ([0-9.]+)s", so).group(1)) for so, _ in outs]
        labels = [np.load(os.path.join(tmp, f"p{rank}.npz"))["pred_clusters"] for rank in range(2)]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    combined = np.concatenate(labels)
    same = bool(np.array_equal(combined, flag6["labels"]))
    score = ari(flag6["y"], combined)
    row = dict(wall_s=wall, call_s=call_s, single_process_wall_s=flag6["wall_s"],
               cells_per_process=[len(x) for x in labels],
               clusters_reported=counts, labels_identical=same, ari=score, launches_by_process=launches,
               problems_by_process=problems)
    print(f"[parallel] two processes over the 4 flagship SBLK blocks: {row}", flush=True)
    if not same or counts[0] != counts[1] or counts[0] != flag6["clusters"]:
        raise AssertionError(f"parallel (c): labels identical {same}, clusters {counts} (one process: "
                             f"{flag6['clusters']})")
    T = math.ceil(API_BLOCK / kn["partition_ncells"])   # folds per block
    for rank in range(2):
        blocks = len(block_slice(API_BLOCKS, rank, 2))
        _gate_launches(f"(c) process {rank}", launches[rank], problems[rank], blocks * T,
                       blocks * math.ceil(T / GROUP), fuses=blocks + 1)
    if score < 0.95 or counts[0] > math.ceil(1.5 * API_TYPES):
        raise AssertionError(f"parallel (c): ARI {score:.4f} (>= 0.95), {counts[0]} clusters "
                             f"(<= {math.ceil(1.5 * API_TYPES)})")
    record.setdefault("parallel", {})["two_processes_4x50000x27998"] = row


# --- the surface the JAX package has beside the main path -------------------
# the group phase 10 (a) asks auto_group for through SHARP_TPU_HBM_BUDGET
SURFACE_GROUP = 4


def _fold_timing(err: str) -> dict:
    """The four parts of the `[fold-timing]` line the grouped pass printed."""
    import re

    lines = [ln for ln in err.splitlines() if ln.startswith("[fold-timing]")]
    if len(lines) != 1:
        raise AssertionError(f"surface (a): {len(lines)} [fold-timing] lines, expected one")
    parts = {k: float(v) for k, v in re.findall(r"(\w+_s)=([0-9.]+)", lines[0])}
    if list(parts) != ["slice_s", "transfer_s", "device_s", "readback_s"]:
        raise AssertionError(f"surface (a): the [fold-timing] line has other keys: {lines[0]}")
    return parts


def phase_surface(dev, record, Xbig, flagship):
    """Phase 10 (a), (b), after phase 5 (b). (a) The flagship block through
    sharp() under SHARP_TPU_FOLD_TIMING=1 and a SHARP_TPU_HBM_BUDGET that
    makes auto_group pick a group of 4: phase 5 (b)'s labels (at group 16),
    every kernel launched, the four parts of the fold pass beside
    fold_ensemble. (b) fuse_folds with the JAX package's positional
    arguments (frs, cfg, N) on that run's fold summaries: the labels and
    cluster count of fuse_folds(frs, cfg). Returns (a)'s launch counts."""
    import contextlib
    import io

    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch.core import large
    from sharp_tpu_torch.ops.silhouette import SWEEP_CHUNK_BYTES
    from sharp_tpu_torch.parallel import sharded

    out = {}
    n, genes = Xbig.shape
    cfg = resolve_config(n, genes, **SEED_KW)
    fold_bytes = sharded._fold_bytes(2048, genes, False, cfg.ensize_K, **sharded._sweep_shape(cfg))
    budget = SWEEP_CHUNK_BYTES + (SURFACE_GROUP + 1) * fold_bytes
    groups, fused = [], []
    real_group, real_fuse = sharded.auto_group, large.fuse_folds

    def group_spy(*a, **k):
        groups.append(real_group(*a, **k))
        return groups[-1]

    def fuse_spy(frs, cfg_, *a, **k):
        fused.append((frs, cfg_))
        return real_fuse(frs, cfg_, *a, **k)

    saved_env = {k: os.environ.get(k) for k in ("SHARP_TPU_FOLD_TIMING", "SHARP_TPU_HBM_BUDGET")}
    os.environ.update(SHARP_TPU_FOLD_TIMING="1", SHARP_TPU_HBM_BUDGET=str(budget))
    sharded.auto_group, large.fuse_folds = group_spy, fuse_spy
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            res, wall, counts, problems, routes = _run_counted(Xbig, device=dev, **SEED_KW)
    finally:
        sharded.auto_group, large.fuse_folds = real_group, real_fuse
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    sys.stderr.write(err.getvalue())
    parts = _fold_timing(err.getvalue())
    fe = _stages(res)["fold_ensemble"]
    same = bool(np.array_equal(res.pred_clusters, flagship.pred_clusters))
    T = len(large.fold_sizes(n, FOLD))
    n_groups = math.ceil(T / SURFACE_GROUP)
    print(
        f"[surface] (a) flagship_50000x27998 with SHARP_TPU_HBM_BUDGET={budget} "
        f"({budget / 2**30:.3f} GiB): auto_group picked {groups}; labels {'identical to' if same else 'DIFFER from'} "
        f"phase 5 (b)'s at group {GROUP}; wall {wall:.3f} s, fold_ensemble {fe:.3f} s; [fold-timing] "
        + " ".join(f"{k}={v:.2f}" for k, v in parts.items())
        + f", sum {sum(parts.values()):.2f} s of fold_ensemble {fe:.3f} s; launches {counts}, problems {problems}",
        flush=True,
    )
    if groups != [SURFACE_GROUP]:
        raise AssertionError(f"surface (a): auto_group picked {groups}, expected [{SURFACE_GROUP}]")
    if not same:
        raise AssertionError("surface (a): the labels at group 4 differ from phase 5 (b)'s at group 16")
    if min(counts.values()) < 1 or counts["rnn_tail"] < n_groups or counts["rnn_round"] < 3 * n_groups:
        raise AssertionError(f"surface (a): a kernel ran too few times for {n_groups} fold groups: {counts}")
    if problems["ward_serial"] < T + 1 or counts["ward_serial"] > n_groups + 1:
        raise AssertionError(f"surface (a): serial Ward took {problems['ward_serial']} problems (>= {T + 1}) "
                             f"in {counts['ward_serial']} launches (<= {n_groups + 1})")
    if counts["cutree"] < counts["ward_serial"] + counts["rnn_tail"] or routes["cutree"]["serial"]:
        raise AssertionError(f"surface (a): a linkage went without its cut replay, or took the serial "
                             f"route: {counts}, {routes}")
    out["fold_timing_group4"] = dict(
        hbm_budget_bytes=budget, group=groups[0], fold_groups=n_groups, labels_identical=same, wall_s=wall,
        fold_ensemble_s=fe, fold_timing=parts, fold_timing_sum_s=sum(parts.values()), launches=counts,
        problems=problems, routes=routes, stages=_stages(res),
    )

    # (b) fuse_folds(frs, cfg, N): N is the block's cell count, unused
    frs, fcfg = fused[0]
    by_pos = large.fuse_folds(frs, fcfg, n, device=dev)
    plain = large.fuse_folds(frs, fcfg, device=dev)
    same_fuse = bool(np.array_equal(by_pos.labels, plain.labels)) and by_pos.n_final == plain.n_final
    print(f"[surface] (b) fuse_folds(frs, cfg, {n}) on the card: n_final {by_pos.n_final}, labels "
          f"{'identical to' if same_fuse else 'DIFFER from'} fuse_folds(frs, cfg)'s (n_final {plain.n_final})",
          flush=True)
    if not same_fuse:
        raise AssertionError("surface (b): fuse_folds(frs, cfg, N) differs from fuse_folds(frs, cfg)")
    out["fuse_folds_positional"] = dict(n_total=n, n_final=by_pos.n_final, plain_n_final=plain.n_final,
                                        identical=same_fuse)
    record["surface"] = out
    return counts


def _launches_of(fn, counts):
    """fn() with every kernel's launch count set to 0 just before it and
    read just after, the card synchronised; the counts are added to
    `counts` and returned beside fn's result."""
    import torch

    from sharp_tpu_torch.ops import linkage_cuda

    linkage_cuda.LAUNCHES.update(dict.fromkeys(linkage_cuda.LAUNCHES, 0))
    out = fn()
    torch.cuda.synchronize()
    got = dict(linkage_cuda.LAUNCHES)
    for k, v in got.items():
        counts[k] = counts.get(k, 0) + v
    return out, got


def _same_link(a, b):
    import torch

    return torch.equal(a.merges, b.merges) and torch.equal(a.heights, b.heights)


def phase_surface_jit(dev, record, Xbig):
    """Phase 10 (d), after (b): the JAX package's jit-compiled entry points
    on the card, each call's launches counted apart from the comparisons.
    (i) ward_linkage_fast and ward_linkage_deferred on (a)'s (15, 512), (b)'s
    (15, 1024) and phase 3's tied (1, 1024) problem: one serial Ward launch
    each, merges and heights identical to ward_linkage_serial and to the
    plain loop; their times. (ii) ward_linkage_deferred(method=m) for the
    other monotone methods on lane 0 of (a): no launch, identical to the
    plain loop on the CPU. (iii) ward_linkage_rnn with tail "xla" and
    "auto" on (d)'s first fold group (80, 2048), f32 and bf16: identical;
    the tail kernel launched 0 and 1 times. (iv) opt_hclust on that group
    with precomputed_link: labels, k and maxsil of the call without it, no
    linkage launch, one cut replay. (v) fold_program on (d)'s first 16
    folds (16, 2048): indN_cluster=6 without has_indN is indN_cluster=None;
    with has_indN=True every member's k is 6. Returns the launches."""
    import torch

    from sharp_tpu_torch.config import pad_dim
    from sharp_tpu_torch.core.fold import fold_program, fold_static_args
    from sharp_tpu_torch.ops.linkage import (
        MONOTONE_METHODS, ward_linkage, ward_linkage_deferred, ward_linkage_fast, ward_linkage_rnn,
    )
    from sharp_tpu_torch.ops.linkage_cuda import ward_linkage_serial
    from sharp_tpu_torch.ops.rp import ternary_rp_matrix
    from sharp_tpu_torch.ops.select import opt_hclust, prep_distance
    from sharp_tpu_torch.utils.prng import fixed_generator

    t0 = time.perf_counter()
    out, counts = {}, {}

    # (i) the serial Ward entry points
    problems = {
        "wang_15x512": _small_tier_distance(dev, 479)[0],
        "cells_15x1024": _small_tier_distance(dev, 1000)[0],
        "smetac_tied_1x1024": _smetac_like_problem(dev, 1024, 1000, seed=3),
    }
    entries = {"ward_linkage_fast": ward_linkage_fast,
               "ward_linkage_deferred": lambda D: ward_linkage_deferred(D, flush=64)}
    rows = out["serial_ward"] = {}
    for pname, D in problems.items():
        K, n = D.shape[0], D.shape[-1]
        kernel = ward_linkage_serial(D)
        plain = ward_linkage(D)
        torch.cuda.synchronize()
        if not _same_link(kernel, plain):
            raise AssertionError(f"surface (d) (i) {pname}: ward_linkage_serial differs from the plain loop")
        for ename, fn in entries.items():
            link, got = _launches_of(lambda: fn(D), counts)
            if got["ward_serial"] != 1 or sum(got.values()) != 1:
                raise AssertionError(f"surface (d) (i) {ename} {pname}: launches {got}, expected one ward_serial")
            if not (_same_link(link, kernel) and _same_link(link, plain)):
                raise AssertionError(f"surface (d) (i) {ename} {pname}: merges or heights differ from "
                                     f"ward_linkage_serial or the plain loop")
            bound, by = _bound(_nbytes(D, link.merges, link.heights), 10.0 * K * (n - 1) * n)
            row = rows.setdefault(ename, {})[pname] = dict(
                shape=[K, n], launches=got["ward_serial"], max_abs_err=0.0, bound_ms=bound, bound_by=by,
                ms=_median_ms(lambda: fn(D), KERNEL_REPS),
                plain_ms=_median_ms(lambda: ward_linkage(D), PLAIN_REPS),
            )
            _device_ms_later(row, "device_ms", lambda fn=fn, D=D: fn(D), "ward_serial_kernel",
                             f"surface (d) {ename} {pname}")
            print(f"[surface] (d) (i) {ename} {pname} ({K}, {n}): one ward_serial launch; merges and heights "
                  f"identical to ward_linkage_serial and the plain loop; {row['ms']:.3f} ms a call (plain "
                  f"{row['plain_ms']:.3f} ms, bound {bound * 1e3:.2f} us)", flush=True)

    # (ii) the other monotone methods: the plain loop on either device
    D0 = problems["wang_15x512"][0].contiguous()
    D0_cpu = D0.cpu()
    rows = out["deferred_methods"] = {}
    for method in sorted(MONOTONE_METHODS - {"ward.D"}):
        link, got = _launches_of(lambda: ward_linkage_deferred(D0, method=method), counts)
        ref = ward_linkage(D0_cpu, method=method)
        same = torch.equal(link.merges.cpu(), ref.merges) and torch.equal(link.heights.cpu(), ref.heights)
        print(f"[surface] (d) (ii) ward_linkage_deferred(method={method!r}) {tuple(D0.shape)}: launches {sum(got.values())}; "
              f"{'identical to' if same else 'DIFFERS from'} the plain loop on the CPU", flush=True)
        if sum(got.values()) or not same:
            raise AssertionError(f"surface (d) (ii) {method}: launches {got}, identical to the CPU {same}")
        rows[method] = dict(launches=sum(got.values()), identical_to_cpu=same)
    del problems, D0, D0_cpu
    torch.cuda.empty_cache()

    # (iii) the ladder's tail, and (iv) opt_hclust with its merges given
    proj, mask, n_real, cfg = _fold_group_features(Xbig, dev)
    D = prep_distance(proj, mask, symmetric=False)[0].contiguous()
    levels = max(0, math.ceil(math.log2(D.shape[-1] / 256)))   # ladder levels above the tail's 256
    rows = out["rnn_tail"] = {}
    for store_name, store in (("f32", None), ("bf16", torch.bfloat16)):
        xla, got_x = _launches_of(lambda: ward_linkage_rnn(D, store_dtype=store, tail="xla"), counts)
        auto, got_a = _launches_of(lambda: ward_linkage_rnn(D, store_dtype=store, tail="auto"), counts)
        same = _same_link(xla, auto)
        print(f"[surface] (d) (iii) ward_linkage_rnn {tuple(D.shape[:2])} {store_name}: tail 'xla' launches "
              f"{got_x}, tail 'auto' launches {got_a}; merges and heights {'identical' if same else 'DIFFER'}",
              flush=True)
        if not same or got_x["rnn_tail"] != 0 or got_a["rnn_tail"] != 1 or got_a["rnn_round"] < levels:
            raise AssertionError(f"surface (d) (iii) {store_name}: identical {same}, launches {got_x}, {got_a}")
        rows[store_name] = dict(xla_launches=got_x, auto_launches=got_a, identical=same)
        if store is None:
            link = auto
        del xla, auto
    del D
    torch.cuda.empty_cache()
    st = fold_static_args(cfg)
    kw = dict(symmetric=False, minN=st["minN"], ncand=st["ncand"], nc_pad=st["nc_pad"])
    base, _ = _launches_of(lambda: opt_hclust(proj, mask, n_real, st["maxN"], **kw), counts)
    given, got = _launches_of(lambda: opt_hclust(proj, mask, n_real, st["maxN"], precomputed_link=link, **kw),
                              counts)
    same = all(torch.equal(getattr(given, f), getattr(base, f)) for f in ("labels", "k", "maxsil"))
    linkage_launches = sum(v for k, v in got.items() if k != "cutree")
    print(f"[surface] (d) (iv) opt_hclust {tuple(proj.shape)} with precomputed_link: launches {got}; labels, k "
          f"and maxsil {'identical to' if same else 'DIFFER from'} the call without it (k "
          f"{base.k.tolist()[:5]}...)", flush=True)
    if not same or linkage_launches or got["cutree"] != 1:
        raise AssertionError(f"surface (d) (iv): identical {same}, launches {got}")
    out["opt_hclust_precomputed_link"] = dict(launches=got, identical=same)
    del proj, mask, link, base, given
    torch.cuda.empty_cache()

    # (v) fold_program's has_indN on the group's 16 folds
    genes, B = Xbig.shape[1], pad_dim(FOLD)
    Xg = torch.zeros((GROUP, B, genes), device=dev)
    for g in range(GROUP):
        Xg[g, :FOLD] = torch.from_numpy(Xbig[g * FOLD : (g + 1) * FOLD]).to(dev)
    sizes = [FOLD] * GROUP
    masks = (torch.arange(B)[None, :] < torch.tensor(sizes)[:, None]).to(dev)
    R = ternary_rp_matrix(fixed_generator(0, dev), genes, cfg.ensize_K * cfg.reduced_ndim)
    runs = {}
    for name, indN, has in (("none", None, False), ("indN6", 6, False), ("indN6_has_indN", 6, True)):
        runs[name], _ = _launches_of(
            lambda: fold_program(Xg, masks, sizes, R, True, indN, has_indN=has, **st), counts)
    same = all(torch.equal(getattr(runs["indN6"], f), getattr(runs["none"], f))
               for f in ("finalC", "n_meta", "k_per", "maxsil"))
    fixed = bool((runs["indN6_has_indN"].k_per == 6).all())
    print(f"[surface] (d) (v) fold_program {tuple(Xg.shape)}: indN_cluster=6 without has_indN "
          f"{'identical to' if same else 'DIFFERS from'} indN_cluster=None (k_per of fold 0 "
          f"{runs['none'].k_per[0].tolist()}); with has_indN=True every member's k is 6: {fixed}", flush=True)
    if not same or not fixed:
        raise AssertionError(f"surface (d) (v): indN ignored {same}, k fixed to 6 {fixed}")
    out["fold_program_has_indN"] = dict(ignored_without_has_indN=same, fixed_with_has_indN=fixed,
                                        k_per_free_fold0=runs["none"].k_per[0].tolist())
    del Xg, runs
    torch.cuda.empty_cache()
    if min(counts.values()) < 1:
        raise AssertionError(f"surface (d): a kernel was never launched: {counts}")
    out["launches"] = counts
    out["phase_s"] = time.perf_counter() - t0
    print(f"[surface] (d) launches of the entry-point calls {counts}; phase {out['phase_s']:.1f} s", flush=True)
    record.setdefault("surface", {})["jit_surface"] = out
    return counts


def phase_surface_codec(record, flag6):
    """Phase 10 (c): the SBLK codec on the first of phase 6 (b)'s blocks,
    50,000 x 27,998: built with g++ and loaded; densify on 1 thread and on
    all threads equal to the numpy plain version bit for bit; the three
    times."""
    from sharp_tpu_torch.io import native

    path = os.path.join(flag6["dir"], "block_00000.sblk")
    lib = native.get_lib()   # built at first use (phase 6 (a)'s host densify)
    if lib is None:
        raise AssertionError("surface (c): the SBLK codec was not built (no g++)")
    # one more build, into a fresh cache, for its time
    saved = os.environ.get("SHARP_TPU_NATIVE_CACHE")
    with tempfile.TemporaryDirectory() as cache:
        os.environ["SHARP_TPU_NATIVE_CACHE"] = cache
        try:
            t0 = time.perf_counter()
            native._build_lib()
            build_s = time.perf_counter() - t0
        finally:
            if saved is None:
                os.environ.pop("SHARP_TPU_NATIVE_CACHE")
            else:
                os.environ["SHARP_TPU_NATIVE_CACHE"] = saved
    n, g, nnz, dt = native.read_header(path)
    row = dict(shape=[n, g], nnz=nnz, dtype_code=dt, library=os.path.basename(lib._name), build_s=build_s,
               host_threads=os.cpu_count())
    t0 = time.perf_counter()
    plain = native._py_densify(path)
    row["plain_s"] = time.perf_counter() - t0
    for label, threads in (("one_thread", 1), ("all_threads", 0)):
        t0 = time.perf_counter()
        got = native.densify(path, threads)
        row[f"{label}_s"] = time.perf_counter() - t0
        row[f"{label}_identical"] = bool(np.array_equal(got, plain))
        del got
    del plain
    print(f"[surface] (c) SBLK codec on block 0 ({n} x {g}, {nnz} nonzeros, {os.cpu_count()} host threads): "
          f"densify 1 thread {row['one_thread_s']:.3f} s, all threads {row['all_threads_s']:.3f} s, numpy plain "
          f"version {row['plain_s']:.3f} s; identical {row['one_thread_identical']} / "
          f"{row['all_threads_identical']}; {row['library']} loaded, g++ build {build_s:.2f} s", flush=True)
    if not (row["one_thread_identical"] and row["all_threads_identical"]):
        raise AssertionError(f"surface (c): the codec's densify differs from the plain version: {row}")
    record.setdefault("surface", {})["codec"] = row


def phase_multihost26(record):
    """Phase 11, after phase 10 (c): scripts/multihost_26block_torch.py's three
    configurations on this card through the script's functions and gates,
    two processes of 13 blocks each (gloo on a free localhost port,
    LOCAL_WORLD_SIZE=2): (a) mechanics, (b) quality, (c) the flagship's 26
    SBLK blocks from io.benchdata's cache (made where missing, kept).
    Returns each kernel's launches in each configuration's cold run, by
    process (each worker starts at 0)."""
    import torch

    mh = _script("multihost_26block_torch")
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="sharp_smoke_mh26_")
    recs = {}
    try:
        for name, timeout in (("mechanics", 240), ("quality", 240), ("flagship", 420)):
            torch.cuda.empty_cache()   # the card's free memory, for the two processes
            recs[name], _ = mh.RUNS[name](work, "cuda", timeout=timeout)
            rec = recs[name]
            print(f"[multihost26] {mh.summary(rec)}", flush=True)
            print(f"[multihost26] {name} launches: cold {rec['cold_launches']}; resume "
                  f"{rec.get('resume_launches')}; one process {rec['single_process_launches']}"
                  + (f"; blocks made in {rec['datagen_seconds']:.1f} s" if "datagen_seconds" in rec else ""),
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t0
    print(f"[multihost26] phase {phase_s:.1f} s", flush=True)
    record["multihost26"] = dict(recs, phase_s=phase_s)
    return {k: {name: [p[k] for p in rec["cold_launches"]] for name, rec in recs.items()} for k in mh.KERNELS}


# --- the JAX side's tuning and profiling programs ---------------------------
# each script and the kernels its run at the JAX script's size launches
# ("rnn" and "rnn_bf16" take the fold program's wMetaC through the ladder's
# tail, so profile_fold launches no serial Ward)
SCRIPT_KERNELS = {
    "tune_linkage_rnn_torch": ("rnn_round", "rnn_pairs", "rnn_tail"),
    "bench_linkage_backends_torch": ("rnn_round", "rnn_tail", "ward_serial"),
    "profile_fold_torch": ("rnn_round", "rnn_tail", "cutree"),
    "profile_fuse_batched_torch": ("rnn_round", "rnn_tail", "ward_serial", "cutree"),
    "profile_fuse_torch": ("ward_serial", "cutree"),
    "debug_bench_quality_torch": ("rnn_round", "rnn_tail", "ward_serial", "cutree"),
}
# the ladder's pair caps above the default that the tuning grid reaches,
# held round by round; its compact_n above 256, where the tail takes the
# rows in global memory
WIDE_PAIR_CAPS = (256, 512)
WIDE_COMPACT_N = 512


def _wide_shapes(dev, D):
    """The kernel shapes the tuning grid reaches on its batch D (20, 2048):
    every round of the ladder at pair_cap 256 and 512, f32 and bf16, held
    against the plain round (and the first round at 2048 timed, its bound
    from `round_bytes`), the whole ladder's merges and heights identical
    with kernel rounds and with plain rounds; the tail at (20, 512) (the
    global tier) against the plain tail."""
    import torch

    from sharp_tpu_torch.ops.linkage import rnn_ladder, ward_linkage_rnn

    rounds, tails = {}, {}
    for store_name, store in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for pc in WIDE_PAIR_CAPS:
            _, first, per_level, held = _capture_rounds(D, store, pair_cap=pc)
            print(f"[scripts] rnn_round {store_name} pair_cap={pc}: {held} rounds of the ladder {tuple(D.shape[:2])} "
                  f"each identical to the plain round; rounds per level {per_level}", flush=True)
            m = max(first)
            rounds[f"{store_name} P={first[m][2]}"] = _hold_round(
                f"rnn_round {store_name} m={m} pair_cap={pc} first round", first[m])
            del first
            kernel = ward_linkage_rnn(D, pair_cap=pc, store_dtype=store, round_impl="pallas")
            plain = ward_linkage_rnn(D, pair_cap=pc, store_dtype=store, round_impl="xla")
            if not (torch.equal(kernel.merges, plain.merges) and torch.equal(kernel.heights, plain.heights)):
                raise AssertionError(f"ladder {store_name} pair_cap={pc}: kernel rounds and plain rounds disagree")
            del kernel, plain
        ladder = rnn_ladder(D, 128, store, WIDE_COMPACT_N)
        tails[store_name], _ = _hold_tail(f"rnn_tail {store_name} compact_n={WIDE_COMPACT_N}", ladder.tail_inputs())
        if tails[store_name]["lanes_by_route"]["rows"] != D.shape[0]:
            raise AssertionError(f"rnn_tail at Cn {WIDE_COMPACT_N}: lanes by route "
                                 f"{tails[store_name]['lanes_by_route']}")
        del ladder
        torch.cuda.empty_cache()
    return rounds, tails


def phase_scripts(dev, record):
    """Phase 12, after phase 11: the six scripts/*_torch.py counterparts of
    the JAX side's tuning and profiling programs, at the JAX scripts' sizes,
    through their functions and gates, each one's launches counted; then
    the kernel shapes their grids reach, against the plain versions (serial
    Ward at (1, 2048) on the backends' data, the ladder's wide pair caps and
    the tail's global tier on the tuning grid's batch). Returns the
    launches by script."""
    import torch

    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.ops.distance import pearson_distance

    t0 = time.perf_counter()
    mods = {name: _script(name) for name in SCRIPT_KERNELS}
    out, launches, shapes = {}, {}, {}

    def counted(name, *args, **kw):
        torch.cuda.empty_cache()
        before = dict(linkage_cuda.LAUNCHES)
        t = time.perf_counter()
        res = mods[name].run(dev, *args, **kw)
        torch.cuda.synchronize()
        launches[name] = {k: n - before[k] for k, n in linkage_cuda.LAUNCHES.items()}
        out[name] = res[0] if isinstance(res, tuple) else res
        for line in mods[name].lines(out[name]):
            print(f"[scripts] {name}: {line}", flush=True)
        print(f"[scripts] {name}: {time.perf_counter() - t:.1f} s, launches {launches[name]}", flush=True)
        return res

    _, D = counted("tune_linkage_rnn_torch")
    shapes["rnn_round"], shapes["rnn_tail"] = _wide_shapes(dev, D)
    del D
    counted("bench_linkage_backends_torch")
    blb = mods["bench_linkage_backends_torch"]
    X, mask = blb.make_points(np.random.default_rng(blb.SEED), 2048, 2000)
    D1 = pearson_distance(torch.from_numpy(X[:1]).to(dev), torch.from_numpy(mask).to(dev)).contiguous()
    shapes["ward_serial"] = {st: _hold_ward("ward_1x2048_backends", D1, 2000, st)[0] for st in ("f32", "bf16")}
    del D1, X
    counted("profile_fold_torch", group=4)
    counted("profile_fuse_batched_torch")
    counted("profile_fuse_torch")
    counted("debug_bench_quality_torch", nfold=6)
    with tempfile.TemporaryDirectory(prefix="sharp_smoke_dump_") as tmp:
        path = os.path.join(tmp, "fuse_debug.npz")
        mods["debug_bench_quality_torch"].dump_cents(path, dev, nfold=2)
        keys = sorted(np.load(path).keys())
    if keys != ["cent_sum", "counts", "finalC", "sizes", "truth"]:
        raise AssertionError(f"debug_bench_quality_torch: DUMP wrote {keys}")
    for name, need in SCRIPT_KERNELS.items():
        missing = [k for k in need if launches[name][k] < 1]
        if missing:
            raise AssertionError(f"{name}: {missing} not launched ({launches[name]})")
    phase_s = time.perf_counter() - t0
    print(f"[scripts] phase {phase_s:.1f} s", flush=True)
    record["scripts"] = dict(out, launches=launches, shapes=shapes, phase_s=phase_s)
    return launches, shapes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no CUDA device to run on",
              file=sys.stderr)
        return 1
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import sharp_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from sharp_tpu_torch.ops import _build
    from synth import make_tpm_like

    dev = torch.device("cuda", 0)
    # read at the start, so that a run that stops at a gate still names its card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[device] {smi}", flush=True)
    record = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    t0 = time.perf_counter()
    report = _build.build_report()
    record["build_s"] = report.seconds
    print(f"[build] {report.seconds:.2f} s, built {report.built or 'nothing (cached)'}", flush=True)
    for src, log in report.log.items():
        for line in log.splitlines():
            # each kernel instance's name, then its registers and spills
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}", flush=True)

    t = time.perf_counter()
    Xbig, ybig = make_tpm_like(**FLAGSHIP)
    record["data_s"] = time.perf_counter() - t
    print(f"[data] flagship block {Xbig.shape} made in {record['data_s']:.1f} s", flush=True)

    rows, tail, rounds = phase_kernels(dev, record, Xbig, ybig)
    phase_slice(dev, record)
    large_counts, flagship = phase_large(dev, record, Xbig, ybig)
    surface_counts = phase_surface(dev, record, Xbig, flagship)
    jit_counts = phase_surface_jit(dev, record, Xbig)
    analysis_counts = phase_analysis(dev, record, Xbig, flagship)
    par_counts = phase_parallel_folds(dev, record, Xbig, ybig, flagship)
    del Xbig, ybig, flagship
    tmp = tempfile.mkdtemp(prefix="sharp_smoke_")
    try:
        unl_counts, unl_problems, flag6 = phase_unlimited(dev, record, tmp)
        # phase 8 (c) and 10 (c) over phase 6 (b)'s SBLK directory, before it is removed
        phase_parallel_processes(dev, record, flag6)
        phase_surface_codec(record, flag6)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mh26_counts = phase_multihost26(record)
    script_counts, wide = phase_scripts(dev, record)
    for row, key, fn, kernel, label in _DEFERRED:
        # a second try where the profiler returned no kernel events
        row[key] = _device_ms(fn, kernel) or _device_ms(fn, kernel)
        print(f"[device] {label}: {row[key]} ms on the card alone", flush=True)
    _DEFERRED.clear()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sharp_tpu"))
    if loaded:
        raise AssertionError(f"the port loaded modules of JAX or of the JAX package: {loaded[:10]}")

    record["total_s"] = time.perf_counter() - t0
    # serial Ward at the shape the main path gives it most: a fold group's
    # wMetaC meta problems in one launch
    ward, cut = rows[f"ward_wmetac_{GROUP}x256"]["f32"], rows["cutree_80x2048"]
    # every serial Ward shape, both storage types, phase 12's too
    ward_err = max(r[st]["max_abs_err"] for r in (*rows.values(), wide["ward_serial"])
                   for st in ("f32", "bf16") if st in r)
    # the round at the main path's largest level: its first round at 2048
    r32 = rounds["f32"][2048]
    round_err = max(r["max_abs_err"] for r in (*(r for st in rounds.values() for r in st.values()),
                                                  *wide["rnn_round"].values()))
    tail_err = max(r["max_abs_err"] for r in (*tail.values(), *wide["rnn_tail"].values()))

    def wide_rows(kernel, ms_key="ms", device_key="device_ms", bound_key="bound_ms"):
        # phase 12's shapes of the kernel: ms a call, the kernel alone, the
        # plain version, the bound
        return {label: {"ms": r[ms_key], "device_ms": r.get(device_key), "plain_ms": r["plain_ms"],
                        "bound_ms": r[bound_key], "shape": r.get("shape")}
                for label, r in wide[kernel].items()}

    def entry(name, replaces, err, ms, plain_ms, bound_ms, bound_by, device_ms=None, source=None, wide_shapes=None):
        # launches: sharp_unlimited over the 4 flagship blocks (problems: the
        # problems or lanes those launches took); launches_by_path adds the
        # large tier's flagship run, phase 7 (a)'s gethclust calls, the
        # flagship block over two shards, phase 10 (a)'s flagship run at
        # group 4, phase 10 (d)'s entry-point calls, phase 11's cold runs
        # (by configuration, one count a process) and phase 12's scripts (by
        # script); wide_shapes: phase 12's new shapes of the kernel.
        # ms: one call through the wrapper (CUDA events); device_ms: the
        # kernel alone (torch.profiler), null where not measured. The round's
        # wrapper launches both of its kernels: rnn_round's ms is the whole
        # round (three launches) and its device_ms the scatter alone;
        # rnn_pairs' ms is its two launches alone (torch.profiler), and its
        # plain version is the plain round, as rnn_round's
        return {
            "name": name, "route": "cuda", "source": f"sharp_tpu_torch/csrc/{source or name}.cu",
            "replaces": replaces, "launches": unl_counts[name], "problems": unl_problems[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "device_ms": device_ms,
            "launches_by_path": {"large": large_counts[name], "unlimited": unl_counts[name],
                                 "analysis": analysis_counts[name], "parallel": par_counts[name],
                                 "surface": surface_counts[name],
                                 "phase 10 (d)": jit_counts[name], "multihost26": mh26_counts[name],
                                 "scripts": {k: c[name] for k, c in script_counts.items()}},
            "wide_shapes": wide_shapes,
        }

    def rp_entry(r):
        # the RP operand kernel at a fold group's shape; launches: phase 6
        # (b)'s sharp_unlimited over the 4 flagship blocks in bf16, one a
        # fold group (gated there), and by path the runs that count them
        # (the large tier's and the two shards' runs are float32: 0);
        # library_ms: today's float32 product of the same operands, and the
        # tensor-core product beside it
        return {
            "name": "rp_operand", "route": "cuda", "source": "sharp_tpu_torch/csrc/rp_operand.cu",
            "replaces": None, "launches": rp_launches["unlimited"], "launches_by_path": rp_launches,
            "max_abs_err": 0.0,
            "ms": r["operand_ms"], "plain_ms": r["operand_plain_ms"], "bound_ms": r["operand_bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"],
            "device_ms": sum(r["operand_device"].values()) or None,
            "product": {"ms": r["product_ms"], "bound_ms": r["product_bound_ms"], "bound_by": "operations",
                        "rel_err": r["product_rel_err"], "device": r["product_device"]},
            "stage": {"ms": r["stage_ms"], "before_ms": r["stage_before_ms"]},
        }

    def sweep_entry(r):
        # the selection sweep's three kernels at a fold group's shape;
        # launches: the large tier's flagship run (phase 5 (b)), by kernel;
        # ms a call with the torch preamble, device_ms the three kernels
        return {
            "name": "sweep", "route": "cuda", "source": "sharp_tpu_torch/csrc/sweep.cu", "replaces": None,
            "launches": record["large"]["flagship_50000x27998"]["auto"]["routes"]["sweep"],
            "max_abs_err": 0.0, "ch_max_rel_err": r["ch_max_rel_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None, "device_ms": r["device_ms"],
            "shape": r["shape"],
        }

    rp_launches = {
        "large": record["large"]["flagship_50000x27998"]["auto"]["routes"]["rp"]["tensor_core"],
        "unlimited": record["unlimited"]["flagship_4x50000x27998"]["routes"]["rp"]["tensor_core"],
    }
    kernels = {
        "kernels": [
            entry("rnn_round", "sharp_tpu/ops/linkage_pallas.py:854", round_err,
                  r32["ms"], r32["plain_ms"], r32["bound_ms"], r32["bound_by"], r32["device_ms"],
                  wide_shapes=wide_rows("rnn_round")),
            entry("rnn_pairs", "sharp_tpu/ops/linkage_pallas.py:854", round_err,
                  r32["pairs_device_ms"], r32["plain_ms"], r32["pairs_bound_ms"], "bytes",
                  r32["pairs_device_ms"], source="rnn_round",
                  wide_shapes=wide_rows("rnn_round", "pairs_device_ms", "pairs_device_ms", "pairs_bound_ms")),
            entry("rnn_tail", "sharp_tpu/ops/linkage_pallas.py:659", tail_err,
                  tail["f32"]["ms"], tail["f32"]["plain_ms"], tail["f32"]["bound_ms"], tail["f32"]["bound_by"],
                  tail["f32"]["device_ms"], wide_shapes=wide_rows("rnn_tail")),
            entry("ward_serial", "sharp_tpu/ops/linkage_pallas.py:993", ward_err,
                  ward["ms"], ward["plain_ms"], ward["bound_ms"], ward["bound_by"], ward["device_ms"],
                  wide_shapes=wide_rows("ward_serial")),
            entry("cutree", "sharp_tpu/ops/linkage_pallas.py:953", cut["cutree_max_abs_err"],
                  cut["cutree_ms"], cut["cutree_plain_ms"], cut["cutree_bound_ms"], cut["cutree_bound_by"],
                  cut["cutree_device_ms"]),
            rp_entry(record["rp"]),
            sweep_entry(record["sweep_80x2048"]),
        ]
    }
    record["kernels_line"] = kernels
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
