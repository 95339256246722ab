#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sharp_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. build    nvcc builds the hand-written kernels (csrc/*.cu) into
              build/kernels/, one nvcc per source, all at once.
  2. data     the flagship block: 50,000 cells x 27,998 genes, 10 planted
              types (tests/synth.py, data seed 0), made once on the host.
  3. kernels  each kernel against its plain PyTorch version on the card.
              Small-tier shapes: serial Ward at (K=15, n=512, 479 real) from
              Pearson distances of projected data, at (1, 640) from a
              wMetaC-like similarity and at (1, 1024, 1000 real), and the
              cut replay on the same merges. Large-tier shapes, from the
              first fold group of the flagship block (G=16 folds x K=5
              members of 2,000 cells at n_pad 2048): the ladder tail at
              (80, 256) on the survivor state the ladder compacts the group
              down to, in f32 and in bf16 storage; the whole ladder with
              the kernel tail against the ladder with the plain tail; the
              cut replay at (80, 2048); serial Ward on the wMetaC problem
              (1, 256). Merges, heights, tail outputs (t < n_alive - 1) and
              snapshots must be identical. Median times from CUDA events
              (kernels 20 launches, plain versions 3), and the ladder's time
              with f32 and with bf16 storage.
  4. slice    the small tier: sharp_tpu_torch.sharp(X, rN_seed=2103,
              exp_type="TPM", device="cuda") at (a) 479 cells x 20,000
              genes, 7 planted types and (b) 1,000 x 20,000: ARI >= 0.9, every
              linkage and cut replay went through the kernels, and at (a) the
              card and the CPU agree with the same numpy-made draws.
  5. large    the large tier. (a) 6,000 x 5,000 (3 folds at n_pad 2048,
              testlog active) on the card and on the CPU with the same
              numpy-made RP matrices, testlog probe and cell reshuffle:
              labels, per-member cluster counts and folds identical; this
              run also warms the card up. (b) The flagship block, 25 folds:
              ARI >= 0.9 against the planted types; every fold group's block
              linkage drained its tail in the tail kernel (launches >= fold
              groups); wMetaC and sMetaC went through serial Ward and the
              cut replay. Then the same block with linkage_backend="rnn_bf16",
              and one more f32 run with the parts of fold_ensemble
              synchronised and timed (fold program per group, projection,
              distances, linkage, cut replay, per-member selections, wMetaC).

The last line of standard output is {"ok": true, "device": {...}}; the line
before it holds the card's name and power limit as nvidia-smi prints them,
and the one before that the kernels' JSON record, whose launch counts come
from the flagship run (b). The full record goes to
chiprun_out/chip_smoke.json. Without a CUDA device the script exits 1 and
prints no result.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_REPS = 20
PLAIN_REPS = 3
SEED_KW = dict(rN_seed=2103, exp_type="TPM")
FLAGSHIP = dict(n_cells=50000, n_genes=27998, n_types=10, seed=0)
FOLD, GROUP = 2000, 16


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


def _wmetac_problem(dev, cfg, y, n_pad, seed):
    """The wMetaC meta problem of one block of len(y) cells padded to n_pad:
    distances of the similarity of K member labellings of planted types y,
    a (1, allc_pad, allc_pad) problem."""
    import torch

    from sharp_tpu_torch.core.pipeline import _allc_pad
    from sharp_tpu_torch.core.wmetac import cluster_similarity
    from sharp_tpu_torch.ops.select import prep_distance

    n = len(y)
    labels = np.full((n_pad, cfg.ensize_K), cfg.nc_pad - 1, np.int32)
    labels[:n] = _wmetac_like_labels(y, cfg.ensize_K, cfg.nc_pad, np.random.default_rng(seed))
    mask = torch.arange(n_pad, device=dev) < n
    allc = _allc_pad(cfg)
    sim = cluster_similarity(
        torch.from_numpy(labels).to(dev), mask, n,
        K=cfg.ensize_K, nc_pad=cfg.nc_pad, allc_pad=allc,
    )
    D, _, _ = prep_distance(sim.S, sim.comp_valid, symmetric=True)
    return D[None].contiguous(), min(sim.total_occ, allc)


def _hold_ward_and_cutree(name, D, n_real, record_rows, ncand=39):
    """Serial Ward and the cut replay on D against their plain versions."""
    import torch

    from sharp_tpu_torch.ops.linkage import ward_linkage
    from sharp_tpu_torch.ops.linkage_cuda import ward_linkage_serial

    K, n = D.shape[0], D.shape[-1]
    got = ward_linkage_serial(D)
    ref = ward_linkage(D)
    torch.cuda.synchronize()
    if not torch.equal(got.merges, ref.merges):
        bad = (got.merges != ref.merges).any(-1).nonzero()
        raise AssertionError(f"{name}: merges differ from the plain loop at {bad[:5].tolist()}")
    err = float((got.heights - ref.heights).abs().max())
    if not torch.equal(got.heights, ref.heights):
        raise AssertionError(f"{name}: heights differ from the plain loop (max abs {err})")
    nr = [n_real] * K
    row = dict(shape=[K, n], n_real=n_real, ward_max_abs_err=err)
    row.update(_hold_cutree(name, got.merges, nr, ncand))
    row["ward_ms"] = _median_ms(lambda: ward_linkage_serial(D), KERNEL_REPS)
    row["ward_plain_ms"] = _median_ms(lambda: ward_linkage(D), PLAIN_REPS)
    record_rows[name] = row
    print(
        f"[kernels] {name} K={K} n={n} n_real={n_real}: merges, heights and cut "
        f"snapshots identical to the plain versions; ward {row['ward_ms']:.3f} ms "
        f"(plain {row['ward_plain_ms']:.3f} ms), cutree {row['cutree_ms']:.3f} ms "
        f"(plain {row['cutree_plain_ms']:.3f} ms)",
        flush=True,
    )
    return row


def _hold_cutree(name, merges, nr, ncand):
    import torch

    from sharp_tpu_torch.ops.linkage import cutree_snapshots
    from sharp_tpu_torch.ops.linkage_cuda import cutree_snapshots_kernel

    snaps = cutree_snapshots_kernel(merges, nr, minN=2, ncand=ncand)
    snaps_ref = cutree_snapshots(merges, nr, minN=2, ncand=ncand)
    torch.cuda.synchronize()
    if not torch.equal(snaps, snaps_ref):
        raise AssertionError(f"{name}: cut snapshots differ from the plain replay")
    return dict(
        cutree_max_abs_err=float((snaps - snaps_ref).abs().max()),
        cutree_ms=_median_ms(
            lambda: cutree_snapshots_kernel(merges, nr, minN=2, ncand=ncand), KERNEL_REPS
        ),
        cutree_plain_ms=_median_ms(
            lambda: cutree_snapshots(merges, nr, minN=2, ncand=ncand), PLAIN_REPS
        ),
    )


def _fold_group_distances(X, dev):
    """The first fold group of the large path on X: G=16 folds of 2,000
    cells at n_pad 2048, log2, projected K ways with one ternary RP matrix
    -> (G*K, 2048, 2048) Pearson distances and the real counts."""
    import torch

    from sharp_tpu.config import pad_dim, resolve_config
    from sharp_tpu_torch.ops.rp import rp_project_ensemble, ternary_rp_matrix
    from sharp_tpu_torch.ops.select import prep_distance
    from sharp_tpu_torch.utils.prng import fixed_generator

    n, genes = X.shape
    cfg = resolve_config(n, genes, **SEED_KW)
    K, p, B = cfg.ensize_K, cfg.reduced_ndim, pad_dim(FOLD)
    Xg = torch.zeros((GROUP, B, genes), device=dev)
    for g in range(GROUP):
        Xg[g, :FOLD] = torch.from_numpy(X[g * FOLD : (g + 1) * FOLD]).to(dev)
    R = ternary_rp_matrix(fixed_generator(0, dev), genes, K * p)
    proj = rp_project_ensemble(torch.log2(1.0 + Xg).reshape(GROUP * B, genes), R, K=K)
    del Xg
    proj = proj.reshape(K, GROUP, B, p).transpose(0, 1).reshape(GROUP * K, B, p)
    mask = (torch.arange(B, device=dev) < FOLD).expand(GROUP * K, B)
    D, _, _ = prep_distance(proj * mask[..., None], mask, symmetric=False)
    return D.contiguous(), cfg


def phase_kernels(dev, record, Xbig, ybig):
    import torch

    from sharp_tpu.config import pad_dim, resolve_config
    from sharp_tpu_torch.ops.linkage import (
        rnn_ladder,
        rnn_tail,
        validate_merge_sequence,
        ward_linkage_rnn,
    )
    from sharp_tpu_torch.ops.linkage_cuda import rnn_tail_kernel
    from sharp_tpu_torch.ops.rp import rp_project_ensemble, ternary_rp_matrix
    from sharp_tpu_torch.ops.select import prep_distance
    from sharp_tpu_torch.utils.prng import fixed_generator
    from synth import make_tpm_like

    rows = {}
    # --- small-tier shapes -------------------------------------------------
    cfg = resolve_config(479, 20000, **SEED_KW)
    X, _ = make_tpm_like(n_cells=479, n_genes=20000, n_types=7, seed=0)
    Xp = torch.zeros((512, 20000), device=dev)
    Xp[:479] = torch.from_numpy(np.log2(1.0 + X)).to(dev)
    mask = torch.arange(512, device=dev) < 479
    R = ternary_rp_matrix(fixed_generator(0, dev), 20000, cfg.ensize_K * cfg.reduced_ndim)
    proj = rp_project_ensemble(Xp, R, K=cfg.ensize_K) * mask[None, :, None]
    D, _, _ = prep_distance(proj, mask, symmetric=False)
    _hold_ward_and_cutree("ward_15x512", D.contiguous(), 479, rows)
    y = np.random.default_rng(1).integers(0, 7, 479)
    D, n_real = _wmetac_problem(dev, cfg, y, 512, seed=0)
    _hold_ward_and_cutree(f"ward_1x{D.shape[-1]}", D, n_real, rows)
    n_pad = pad_dim(1000)
    Z = torch.zeros((1, n_pad, 250), device=dev)
    Z[0, :1000] = torch.randn((1000, 250), generator=fixed_generator(1, dev), device=dev)
    mask = torch.arange(n_pad, device=dev) < 1000
    D, _, _ = prep_distance(Z, mask, symmetric=False)
    _hold_ward_and_cutree(f"ward_1x{n_pad}", D.contiguous(), 1000, rows)

    # --- large-tier shapes: the first fold group of the flagship block ------
    D, big_cfg = _fold_group_distances(Xbig, dev)
    L = D.shape[0]
    tail = {}
    links = {}
    for store_name, store in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        # the survivor state the ladder compacts the group down to
        ladder = rnn_ladder(D, store_dtype=store)
        args = ladder.tail_inputs()
        Cn = args[0].shape[-1]
        got = rnn_tail_kernel(*args)
        ref = rnn_tail(*args)
        torch.cuda.synchronize()
        n_alive = args[1].sum(dim=1).long()
        valid = torch.arange(Cn, device=dev)[None, :] < (n_alive - 1)[:, None]
        for what, a, b in zip(("mi", "mj", "hh"), got, ref):
            if not torch.equal(a[valid], b[valid]):
                raise AssertionError(f"rnn_tail {store_name}: {what} differs from the plain tail")
        err = float((got[2] - ref[2])[valid].abs().max())
        # the whole ladder: ward_linkage_rnn (kernel tail) against the same
        # rounds finished by the plain tail, on the card
        link = ward_linkage_rnn(D, store_dtype=store)
        plain_link = ladder.finish(*ref)
        if not (torch.equal(link.merges, plain_link.merges) and torch.equal(link.heights, plain_link.heights)):
            raise AssertionError(f"ladder {store_name}: the kernel tail and the plain tail disagree")
        for lane in (0, L - 1):
            errs = validate_merge_sequence(link.merges[lane], link.heights[lane], FOLD, D.shape[-1])
            if errs:
                raise AssertionError(f"ladder {store_name} lane {lane}: {errs}")
        links[store_name] = link
        tail[store_name] = dict(
            shape=[L, Cn], n_alive_min=int(n_alive.min()), n_alive_max=int(n_alive.max()),
            max_abs_err=err,
            ms=_median_ms(lambda: rnn_tail_kernel(*args), KERNEL_REPS),
            plain_ms=_median_ms(lambda: rnn_tail(*args), PLAIN_REPS),
        )
        print(
            f"[kernels] rnn_tail {store_name} L={L} Cn={Cn} (n_alive {tail[store_name]['n_alive_min']}-"
            f"{tail[store_name]['n_alive_max']}): mi, mj, hh identical to the plain tail; the whole "
            f"ladder identical with either tail; kernel {tail[store_name]['ms']:.3f} ms (plain "
            f"{tail[store_name]['plain_ms']:.3f} ms)",
            flush=True,
        )
    ladder_ms = {}
    for store_name in ("f32", "bf16", "bf16", "f32"):
        store = torch.float32 if store_name == "f32" else torch.bfloat16
        ladder_ms.setdefault(store_name, []).append(
            _median_ms(lambda: ward_linkage_rnn(D, store_dtype=store), 3)
        )
    ladder_ms = {k: float(np.mean(v)) for k, v in ladder_ms.items()}
    print(
        f"[kernels] ladder (80, 2048) with the tail kernel: f32 {ladder_ms['f32']:.3f} ms, "
        f"bf16 {ladder_ms['bf16']:.3f} ms (medians of 3, turns f32, bf16, bf16, f32)",
        flush=True,
    )
    record["ladder_80x2048_ms"] = ladder_ms
    record["rnn_tail"] = tail
    big = dict(_hold_cutree("cutree_80x2048", links["f32"].merges, [FOLD] * L, 39))
    big["shape"] = [L, D.shape[-1]]
    rows["cutree_80x2048"] = big
    print(
        f"[kernels] cutree_80x2048 on the ladder's merges: identical to the plain replay; "
        f"{big['cutree_ms']:.3f} ms (plain {big['cutree_plain_ms']:.3f} ms)",
        flush=True,
    )
    del D, links
    D, n_real = _wmetac_problem(dev, big_cfg, ybig[:FOLD], pad_dim(FOLD), seed=2)
    _hold_ward_and_cutree("ward_wmetac_fold", D, n_real, rows)
    record["kernels"] = rows
    torch.cuda.empty_cache()
    return rows, tail


def _counters():
    from sharp_tpu_torch.ops.linkage_cuda import (
        cutree_snapshots_kernel,
        rnn_tail_kernel,
        ward_linkage_serial,
    )

    return {"ward_serial": ward_linkage_serial, "cutree": cutree_snapshots_kernel, "rnn_tail": rnn_tail_kernel}


def _run_counted(X, **kw):
    import torch

    import sharp_tpu_torch

    for fn in _counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = sharp_tpu_torch.sharp(X, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in _counters().items()}
    return res, wall, counts


def _stages(res):
    return {s["stage"]: s["seconds"] for s in res.timing["stages"]}


def phase_slice(dev, record):
    from sharp_tpu.analysis.ari import ari
    from sharp_tpu.config import resolve_config
    from sharp_tpu_torch import carry
    from sharp_tpu_torch.core.pipeline import preprocess
    from synth import make_tpm_like

    import sharp_tpu_torch

    out = {}
    for name, n in (("wang_479x20000", 479), ("cells_1000x20000", 1000)):
        X, y = make_tpm_like(n_cells=n, n_genes=20000, n_types=7, seed=0)
        if name.startswith("wang"):
            sharp_tpu_torch.sharp(X, device=dev, **SEED_KW)  # warm-up: CUDA context, cuBLAS
        res, wall, counts = _run_counted(X, device=dev, **SEED_KW)
        score = ari(y, res.pred_clusters)
        stages = _stages(res)
        print(
            f"[slice] {name}: {res.N_pred_cluster} clusters, ARI {score:.4f}, "
            f"per-member k {res.per_member_k.tolist()}, wall {wall:.3f} s, "
            f"launches {counts}",
            flush=True,
        )
        print(f"[slice] {name} stages (s): {json.dumps(stages)}", flush=True)
        if score < 0.9:
            raise AssertionError(f"{name}: ARI {score:.4f} < 0.9")
        # one block linkage, one wMetaC meta linkage, two testlog probes
        if counts["ward_serial"] < 4 or counts["cutree"] < 4:
            raise AssertionError(f"{name}: the kernels were not launched on every linkage: {counts}")
        out[name] = dict(
            n_cells=n, clusters=res.N_pred_cluster, ari=score, wall_s=wall,
            stages=stages, launches=counts, per_member_k=res.per_member_k.tolist(),
        )
        if name.startswith("wang"):
            cfg = resolve_config(n, X.shape[1], **SEED_KW)
            genes = preprocess(X, cfg).shape[1]
            K, p = cfg.ensize_K, cfg.reduced_ndim
            rng = np.random.default_rng(2103)
            R = carry.rp_from_jax(_ternary(rng, genes, K * p), K, p)
            probe = carry.testlog_probe_from_jax(rng.permutation(n), _ternary(rng, genes, p), n, genes, p)
            on_card = sharp_tpu_torch.sharp(X, rM=R, testlog_probe=probe, device=dev, **SEED_KW)
            t0 = time.perf_counter()
            on_cpu = sharp_tpu_torch.sharp(X, rM=R, testlog_probe=probe, device="cpu", **SEED_KW)
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
    record["slice"] = out


def _timed_parts(torch):
    """Wrap the large tier's parts in synchronised host timers: the fold
    program per group (the rest of fold_ensemble is the host staging of the
    group and its copy to the card) and, inside it, the projection, the
    distances, the block linkage call, the cut replay, the per-member
    selections and wMetaC."""
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


def phase_large(dev, record, Xbig, ybig):
    import torch

    from sharp_tpu.analysis.ari import ari
    from sharp_tpu.config import resolve_config
    from sharp_tpu_torch import carry
    from sharp_tpu_torch.core.large import fold_sizes
    from sharp_tpu_torch.core.pipeline import preprocess
    from synth import make_tpm_like

    import sharp_tpu_torch

    out = {}
    # (a) card vs CPU with the same draws; also the warm-up of the large tier
    n = 6000
    X, y = make_tpm_like(n_cells=n, n_genes=5000, n_types=10, seed=0)
    cfg = resolve_config(n, X.shape[1], **SEED_KW)
    genes = preprocess(X, cfg).shape[1]
    K, p = cfg.ensize_K, cfg.reduced_ndim
    rng = np.random.default_rng(6000)
    draws = dict(
        rM=carry.rp_from_jax(_ternary(rng, genes, K * p), K, p),
        testlog_probe=carry.testlog_probe_from_jax(rng.permutation(n), _ternary(rng, genes, p), n, genes, p),
        shuffle_perm=carry.shuffle_perm_from_jax(rng.permutation(n), n),
    )
    on_card, wall, counts = _run_counted(X, device=dev, **draws, **SEED_KW)
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
    for backend in ("auto", "rnn_bf16"):
        res, wall, counts = _run_counted(Xbig, device=dev, linkage_backend=backend, **SEED_KW)
        score = ari(ybig, res.pred_clusters)
        stages = _stages(res)
        runs[backend] = dict(
            wall_s=wall, ari=score, clusters=res.N_pred_cluster, stages=stages, launches=counts,
        )
        print(
            f"[large] flagship_50000x27998 linkage_backend={backend}: {res.N_pred_cluster} clusters, "
            f"ARI {score:.4f}, {T} folds, wall {wall:.3f} s, launches {counts}",
            flush=True,
        )
        print(f"[large] flagship_50000x27998 {backend} stages (s): {json.dumps(stages)}", flush=True)
        if backend == "auto":
            main_counts = counts
            if score < 0.9:
                raise AssertionError(f"flagship: ARI {score:.4f} < 0.9")
            if counts["rnn_tail"] < math.ceil(T / GROUP):
                raise AssertionError(f"flagship: the tail kernel ran {counts['rnn_tail']} times "
                                     f"for at least {math.ceil(T / GROUP)} fold groups")
            # wMetaC per fold + sMetaC: serial Ward; every opt_hclust: the cut replay
            if counts["ward_serial"] < T + 1 or counts["cutree"] < T + 1 + counts["rnn_tail"]:
                raise AssertionError(f"flagship: wMetaC/sMetaC did not go through the kernels: {counts}")

    # (c) one more f32 run with the fold program's parts timed
    acc, saved = _timed_parts(torch)
    try:
        res, wall, _ = _run_counted(Xbig, device=dev, **SEED_KW)
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
    fe = _stages(res)["fold_ensemble"]
    parts = {k: dict(seconds=v, share_of_fold_ensemble=v / fe) for k, v in acc.items()}
    print(
        f"[large] flagship parts, synchronised (fold_ensemble {fe:.3f} s, wall {wall:.3f} s): "
        + ", ".join(f"{k} {v['seconds']:.3f} s ({100 * v['share_of_fold_ensemble']:.1f}%)" for k, v in parts.items()),
        flush=True,
    )
    runs["parts"] = dict(fold_ensemble_s=fe, wall_s=wall, parts=parts)
    out["flagship_50000x27998"] = runs
    record["large"] = out
    return main_counts


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
    record = {"device": torch.cuda.get_device_name(0)}
    t0 = time.perf_counter()
    report = _build.build_report()
    record["build_s"] = report.seconds
    print(f"[build] {report.seconds:.2f} s, built {report.built or 'nothing (cached)'}", flush=True)
    for src, log in report.log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}", flush=True)

    t = time.perf_counter()
    Xbig, ybig = make_tpm_like(**FLAGSHIP)
    record["data_s"] = time.perf_counter() - t
    print(f"[data] flagship block {Xbig.shape} made in {record['data_s']:.1f} s", flush=True)

    rows, tail = phase_kernels(dev, record, Xbig, ybig)
    phase_slice(dev, record)
    main_counts = phase_large(dev, record, Xbig, ybig)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    record["nvidia_smi"] = smi
    record["total_s"] = time.perf_counter() - t0
    ward, cut = rows["ward_wmetac_fold"], rows["cutree_80x2048"]
    kernels = {
        "kernels": [
            {
                "name": "rnn_tail", "route": "cuda",
                "source": "sharp_tpu_torch/csrc/rnn_tail.cu",
                "replaces": "sharp_tpu/ops/linkage_pallas.py:659",
                "launches": main_counts["rnn_tail"],
                "max_abs_err": max(tail["f32"]["max_abs_err"], tail["bf16"]["max_abs_err"]),
                "ms": tail["f32"]["ms"], "plain_ms": tail["f32"]["plain_ms"],
            },
            {
                "name": "ward_serial", "route": "cuda",
                "source": "sharp_tpu_torch/csrc/ward_serial.cu",
                "replaces": "sharp_tpu/ops/linkage_pallas.py:993",
                "launches": main_counts["ward_serial"],
                "max_abs_err": ward["ward_max_abs_err"],
                "ms": ward["ward_ms"], "plain_ms": ward["ward_plain_ms"],
            },
            {
                "name": "cutree", "route": "cuda",
                "source": "sharp_tpu_torch/csrc/cutree.cu",
                "replaces": "sharp_tpu/ops/linkage_pallas.py:953",
                "launches": main_counts["cutree"],
                "max_abs_err": cut["cutree_max_abs_err"],
                "ms": cut["cutree_ms"], "plain_ms": cut["cutree_plain_ms"],
            },
        ]
    }
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
