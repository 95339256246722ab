"""bench_torch.py's compute path and `sharp_unlimited` at the bench's
declared size, against the JAX package on the CPU, and the bench's pure
parts.

The compute path: three blocks (600 + 600 + 700 cells x 200 genes, folds
of 250 at n_pad 256, K=3, p=16) from numpy seed data go through
`bench_torch`'s fold pass (groups of 4 folds, the last padded, as the
bench pads its last group), its batched block fuses and its global fuse,
and through the composition of JAX functions that bench.py runs
(:249-445): `jax.vmap` of `core/fold.fold_program` per group,
`summaries_to_host`, `fuse_blocks`, `parallel/streaming.global_block_fuse`
and `finalize_labels`. One numpy RP matrix in bf16, as the bench's, goes
to both. Each case runs twice: with `cfg.n_cells` the real 1,900 cells
and the declared 1,306,127, where smetac_range widens every fuse to minN
26 and maxN 262, so that blocks of fewer clusters take the floor's clamp
(`core/large.py:_smetac_block_shapes`). Labels are integers: the per-block
fused labels and the final labels must be identical.

One torch thread; the file takes about a minute alone.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
import sharp_tpu.parallel.streaming as jstream
from sharp_tpu.config import resolve_config as j_resolve_config
from sharp_tpu.core import fold as jfold
from sharp_tpu.core import large as jlarge
from sharp_tpu.types import finalize_labels as j_finalize_labels
from sharp_tpu_torch import sharp_unlimited
from sharp_tpu_torch.config import pad_dim
from sharp_tpu_torch.io.blocks import save_blocks
from sharp_tpu_torch.parallel import streaming
from tests.synth import make_tpm_like
from tests.torch_mh_worker import shared_rp

BLOCKS, GENES, FOLD, K, P, GROUP = [600, 600, 700], 200, 250, 3, 16, 4
DECLARED = 1306127
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench_data():
    X, y = make_tpm_like(n_cells=sum(BLOCKS), n_genes=GENES, n_types=5, seed=23)
    R = shared_rp(K, GENES, P)
    plan = bench_torch.fold_plan(BLOCKS, FOLD)
    starts = np.concatenate([[0], np.cumsum([sz for _, sz in plan])])
    B = pad_dim(max(sz for _, sz in plan))

    def group(t0, sizes):
        """(X (G, B, genes), planted types (G, B)) of folds t0.. of X; a
        lane past the last fold repeats the group's first fold."""
        Xg = np.zeros((len(sizes), B, GENES), np.float32)
        ys = np.zeros((len(sizes), B), np.int64)
        for gi, sz in enumerate(sizes):
            t = t0 + gi if t0 + gi < len(plan) else t0
            Xg[gi, :sz] = X[starts[t] : starts[t] + sz]
            ys[gi, :sz] = y[starts[t] : starts[t] + sz]
        return Xg, ys

    return dict(X=X, y=y, R=R, plan=plan, B=B, group=group)


def _env(n_cells):
    return dict(n_cells=n_cells, n_genes=GENES, n_types=5, K=K, p=P, fold=FOLD, min_ari=0.8, blocks=BLOCKS)


def _jax_composition(d, n_cells):
    """bench.py's composition of JAX functions over the same folds."""
    cfg = j_resolve_config(n_cells, GENES, ensize_K=K, reduced_ndim=P, partition_ncells=FOLD, rN_seed=7,
                           dtype_compute="bfloat16", forview=False)
    static = jfold.fold_static_args(cfg)
    R = jnp.asarray(d["R"], jnp.bfloat16)
    run = jax.jit(jax.vmap(
        lambda X, m, nr: jfold.fold_program(X, m, nr, R, jnp.asarray(True), None, has_indN=False, **static)
    ))
    plan, B = d["plan"], d["B"]
    block_frs = [[] for _ in BLOCKS]
    for g0 in range(0, len(plan), GROUP):
        gplan = plan[g0 : g0 + GROUP]
        sizes = [sz for _, sz in gplan]
        pad = sizes + [sizes[0]] * (GROUP - len(sizes))
        Xg, _ = d["group"](g0, pad)
        masks = np.arange(B)[None, :] < np.asarray(pad)[:, None]
        out = run(jnp.asarray(Xg), jnp.asarray(masks), jnp.asarray(pad, jnp.int32))
        frs = jlarge.summaries_to_host(out, sizes + [0] * (GROUP - len(sizes)), False)
        for gi, (bi, _) in enumerate(gplan):
            block_frs[bi].append(frs[gi])
    fused = jlarge.fuse_blocks(block_frs, cfg)
    summaries, labels = [], []
    for fres in fused:
        uniq = np.unique(fres.labels)
        summaries.append((fres.cents[uniq], fres.counts[uniq]))
        labels.append(np.searchsorted(uniq, fres.labels))
    tf, remap, offsets, _, _ = jstream.global_block_fuse(summaries, cfg)
    raw = np.concatenate([remap[tf[offsets[bi] + labels[bi]]] for bi in range(len(BLOCKS))])
    return fused, j_finalize_labels(raw.astype(np.int32), merge_tiny=True)


@pytest.mark.parametrize("n_cells", [sum(BLOCKS), DECLARED], ids=["real", "declared_1306127"])
def test_compute_path_matches_the_jax_composition(bench_data, n_cells):
    d = bench_data
    cfg = bench_torch.bench_config(_env(n_cells))
    if n_cells == DECLARED:
        assert (cfg.maxN_cluster, cfg.nc_pad) == (262, 48)

    def group(t0, sizes):
        Xg, ys = d["group"](t0, sizes)
        return torch.from_numpy(Xg), torch.from_numpy(ys)

    R = torch.from_numpy(d["R"]).to(torch.bfloat16)
    fp = bench_torch.fold_pass(group, d["plan"], d["B"], R, cfg, GROUP, CPU, len(BLOCKS))
    assert len(fp["group_seconds"]) == 3 and [len(f) for f in fp["block_frs"]] == [3, 3, 3]
    np.testing.assert_array_equal(np.concatenate(fp["truth"]), d["y"])
    fused, summaries, block_labels = bench_torch.block_fuse(fp["block_frs"], cfg, CPU)
    labels = bench_torch.global_fuse(summaries, block_labels, cfg, CPU)

    ref_fused, ref_labels = _jax_composition(d, n_cells)
    for mine, theirs in zip(fused, ref_fused):
        np.testing.assert_array_equal(mine.labels, theirs.labels)
        assert mine.n_final == theirs.n_final
    np.testing.assert_array_equal(labels, ref_labels)
    assert len(np.unique(labels)) >= 3
    if n_cells == DECLARED:
        # every block has fewer clusters than the widened floor of 26
        per_block, glob = bench_torch._fuse_shapes(fp["block_frs"], summaries, cfg)
        assert max(max(r["clusters"]) for r in per_block.values()) < 26
        assert glob["clusters"] == sum(len(c) for _, c in summaries)


def test_sharp_unlimited_at_the_declared_size_matches_jax(tmp_path, monkeypatch):
    """Three SBLK blocks declared as 1,306,127 cells (the JAX package's
    precedent: scripts/multihost_26block.py's "mechanics" configuration):
    the widened fuse ranges on both sides, labels identical."""
    monkeypatch.setattr(
        jstream, "ensemble_rp_matrix",
        lambda key, K, m, p, dtype=jnp.float32: jnp.asarray(shared_rp(K, m, p), dtype),
    )
    monkeypatch.setattr(
        streaming, "ensemble_rp_matrix",
        lambda seed, K, m, p, dtype=torch.float32, device="cuda": torch.from_numpy(shared_rp(K, m, p)).to(device, dtype),
    )
    X, _ = make_tpm_like(n_cells=600, n_genes=200, n_types=4, seed=31)
    d = str(tmp_path / "sblk")
    save_blocks(d, [X[:200], X[200:420], X[420:]], fmt="sblk")
    kw = dict(n_cells=DECLARED, rN_seed=7, ensize_K=3, reduced_ndim=16, partition_ncells=120, forview=False,
              dtype_compute="bfloat16", resume=False)
    ref = jstream.sharp_unlimited(d, manifest_dir=str(tmp_path / "jm"), **kw)
    got = sharp_unlimited(d, manifest_dir=str(tmp_path / "tm"), device="cpu", **kw)
    assert got.paras["n_cells"] == DECLARED and got.paras["maxN_cluster"] == 262
    np.testing.assert_array_equal(got.pred_clusters, ref.pred_clusters)
    assert got.distr_pred_clusters == ref.distr_pred_clusters
    assert got.N_pred_cluster >= 3


def test_bench_env_block_plan_and_config(monkeypatch):
    """The default workload: 26 blocks, the last 56,127 cells; 654 folds
    (25 of every 50,000-cell block, 29 of the last) at n_pad 2048; the
    configuration the JAX bench resolves."""
    for k in list(os.environ):
        if k.startswith("SHARP_BENCH_"):
            monkeypatch.delenv(k)
    env = bench_torch._bench_env()
    assert env["n_cells"] == 1306127 and env["n_genes"] == 27998 and env["n_types"] == 38
    assert (env["K"], env["p"], env["fold"], env["min_ari"]) == (5, 256, 2000, 0.80)
    assert env["blocks"] == [50000] * 25 + [56127]
    cfg = bench_torch.bench_config(env)
    plan = bench_torch.fold_plan(env["blocks"], cfg.partition_ncells)
    assert len(plan) == 654 and sum(sz for _, sz in plan) == 1306127
    assert sum(1 for bi, _ in plan if bi == 25) == 29
    assert pad_dim(max(sz for _, sz in plan)) == 2048
    assert -(-len(plan) // 16) == 41
    ref = j_resolve_config(1306127, 27998, ensize_K=5, reduced_ndim=256, partition_ncells=2000, rN_seed=7,
                           dtype_compute="bfloat16", forview=False)
    assert cfg.as_dict() == ref.as_dict()
    monkeypatch.setenv("SHARP_BENCH_QUICK", "1")
    quick = bench_torch._bench_env()
    assert quick["blocks"] == [65536] and (quick["n_types"], quick["min_ari"]) == (12, 0.95)


def test_quality_and_api_gates():
    """The compute gates (ARI floor; cluster count in [max(2, types // 3),
    ceil(1.5 types)]) and the API path's subset rule: a subset under 1e6
    cells is held to ARI 0.95, the whole run to the configured floor."""
    assert bench_torch.quality_gates("compute", 0.85, 38, 38, 0.80) == []
    assert len(bench_torch.quality_gates("compute", 0.79, 38, 38, 0.80)) == 1
    assert bench_torch.quality_gates("compute", 0.9, 57, 38, 0.80) == []
    assert "> 1.5x" in bench_torch.quality_gates("compute", 0.9, 58, 38, 0.80)[0]
    assert bench_torch.quality_gates("compute", 0.9, 12, 38, 0.80) == []
    assert "over-merged" in bench_torch.quality_gates("compute", 0.9, 11, 38, 0.80)[0]
    assert len(bench_torch.quality_gates("compute", 0.5, 70, 38, 0.80)) == 2
    msgs, floor = bench_torch.api_gates(0.93, 38, 38, 0.80, subset=True, n_cells=200000)
    assert floor == 0.95 and len(msgs) == 1
    msgs, floor = bench_torch.api_gates(0.93, 38, 38, 0.80, subset=False, n_cells=1306127)
    assert floor == 0.80 and msgs == []
    msgs, _ = bench_torch.api_gates(0.99, 58, 38, 0.80, subset=True, n_cells=200000)
    assert len(msgs) == 1 and "> 1.5x" in msgs[0]


def test_card_generator_design_on_the_cpu():
    """The on-card generator's output on the CPU: every lane B cells
    scaled to 1e6, about 20% dropout, planted types in range, the same
    folds from the same seeds whatever the group."""
    make = bench_torch.card_generator(500, 6, 64, CPU)
    Xg, ys = make(3, [64, 40])
    assert Xg.shape == (2, 64, 500) and ys.shape == (2, 64)
    np.testing.assert_allclose(Xg.sum(dim=2).numpy(), 1e6, rtol=1e-4)
    assert 0.15 < float((Xg == 0).float().mean()) < 0.25
    assert int(ys.min()) >= 0 and int(ys.max()) < 6
    X4, y4 = bench_torch.card_generator(500, 6, 64, CPU)(4, [64])
    assert torch.equal(X4[0], Xg[1]) and torch.equal(y4[0], ys[1])


def test_compute_path_on_the_cpu(tmp_path, monkeypatch):
    """`compute_path` end to end on the CPU at a tiny size (2 blocks of
    1,000 cells x 1,000 genes, 8 folds in 2 groups of 4): bench.py's line
    and its added fields, the exit code of the gates, the stages and the
    profiler trace; then a failing parity pre-check gives bench.py's error
    line and exit code 2 before any timing."""
    from sharp_tpu_torch.ops import linkage

    env = dict(n_cells=2000, n_genes=1000, n_types=4, K=2, p=32, fold=250, min_ari=0.5, blocks=[1000, 1000])
    line, msgs, rc, rec = bench_torch.compute_path(env, CPU, group=4, profile_dir=str(tmp_path))
    d = line["detail"]
    assert (line["metric"], line["unit"]) == ("cells_per_second_end_to_end", "cells/s")
    assert rc == (1 if msgs else 0) and d["ari_gate_passed"] == (not msgs)
    assert line["value"] == pytest.approx(2000 / d["total_seconds"])
    assert line["vs_baseline"] == pytest.approx(line["value"] * 9.771 / 479)
    assert d["total_seconds"] == pytest.approx(d["fold_pass_seconds"] + d["block_fuse_seconds"]
                                               + d["global_fuse_seconds"])
    assert (d["n_folds"], d["n_blocks"], d["fold_group_size"], d["linkage_backend"]) == (8, 2, 4, "serial")
    assert d["fold_group_seconds"]["n"] == 2 and d["block_fuse_each_seconds_untimed"]["n"] == 2
    assert d["fold_pass_seconds"] == pytest.approx(sum(rec["group_seconds"]))
    assert set(d["launches"]) == {"fold_pass", "block_fuse", "global_fuse"}
    assert {"rp_project_s", "distance_s", "linkage_s", "fold_program_total_s"} <= set(d["stages"])
    assert os.path.getsize(tmp_path / "bench_torch_fold_pass.json") > 0

    monkeypatch.setattr(linkage, "validate_merge_sequence", lambda *a: ["1 self-merges"])
    line, msgs, rc, _ = bench_torch.compute_path(env, CPU, group=4)
    assert rc == 2 and line["value"] == 0.0
    assert line["detail"]["error"] == "linkage parity pre-check FAILED on device"
    assert set(line["detail"]["problems"]) == {"rnn_f32", "rnn_bf16", "serial_f32"}


def test_make_blocks_writes_what_gen_block_writes(tmp_path):
    """`io.benchdata.make_blocks` makes the missing blocks in a pool of
    spawned processes: each file holds the bytes `gen_block` writes in this
    process, and only a missing block is made again."""
    from sharp_tpu_torch.io import benchdata

    blocks, G, n_types, keep = [40, 40, 56], 300, 4, 64
    ddir = str(tmp_path / "pool")
    assert benchdata.make_blocks(ddir, blocks, G, n_types, keep) > 0
    tm, top, n_top = benchdata.type_means(G, n_types, keep)
    path = lambda bi: os.path.join(ddir, f"block_{bi:05d}.sblk")  # noqa: E731
    for bi, bn in enumerate(blocks):
        one = str(tmp_path / f"one_{bi}.sblk")
        benchdata.gen_block(one, bi, bn, G, keep, tm, top, n_top)
        with open(one, "rb") as a, open(path(bi), "rb") as b:
            assert a.read() == b.read()
    assert benchdata.make_blocks(ddir, blocks, G, n_types, keep) == 0.0
    kept = os.stat(path(0)).st_mtime_ns
    os.remove(path(1))
    assert benchdata.make_blocks(ddir, blocks, G, n_types, keep) > 0
    assert os.path.exists(path(1)) and os.stat(path(0)).st_mtime_ns == kept
