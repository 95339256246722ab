"""The atlas solution that the benchmark's `flagship_1p3m.device_fed`
times, and `sharp_unlimited` at the atlas's declared size, against the JAX
package on the CPU, and the pure parts of bench_torch.py.

The atlas solution: three blocks (600 + 600 + 700 cells x 200 genes, folds
of 250 at n_pad 256, K=3, p=16) from numpy seed data go through the port's
functions in the order `perfbench/traffic/device_fed.py` runs them
(`core/fold.fold_program` over groups of 4 folds, the last group's lanes
padded, `core/large.summaries_to_host`, one `fuse_blocks` over all blocks,
`parallel/streaming.global_block_fuse` and `finalize_labels`), and through
the same composition of JAX functions (`jax.vmap` of the fold program per
group). One numpy RP matrix in bf16 goes to both. Each case runs twice:
with `cfg.n_cells` the real 1,900 cells and the declared 1,306,127, where
smetac_range widens every fuse to minN 26 and maxN 262, so that blocks of
fewer clusters take the floor's clamp (`core/large.py:_smetac_block_shapes`).
Labels are integers: the per-block fused labels and the final labels must
be identical.

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
from sharp_tpu_torch.config import pad_dim, resolve_config
from sharp_tpu_torch.core import large as tlarge
from sharp_tpu_torch.core.fold import fold_program, fold_static_args
from sharp_tpu_torch.io.blocks import save_blocks
from sharp_tpu_torch.parallel import streaming
from sharp_tpu_torch.types import finalize_labels
from tests.synth import make_tpm_like
from tests.torch_mh_worker import shared_rp
from torch_threads import one_torch_thread  # noqa: F401

BLOCKS, GENES, FOLD, K, P, GROUP = [600, 600, 700], 200, 250, 3, 16, 4
DECLARED = 1306127
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bench_data():
    X, y = make_tpm_like(n_cells=sum(BLOCKS), n_genes=GENES, n_types=5, seed=23)
    R = shared_rp(K, GENES, P)
    plan = [(bi, sz) for bi, bn in enumerate(BLOCKS) for sz in tlarge.fold_sizes(bn, FOLD)]
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


def _jax_composition(d, n_cells):
    """The JAX package's composition over the same folds."""
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


def _port_solution(d, n_cells):
    """The port's atlas solution over the folds, in the order
    `device_fed` runs it -> (block fold summaries, fused blocks, final
    labels, planted types of the real lanes, fold groups)."""
    cfg = resolve_config(n_cells, GENES, ensize_K=K, reduced_ndim=P, partition_ncells=FOLD, rN_seed=7,
                         dtype_compute="bfloat16", forview=False)
    static = fold_static_args(cfg)
    R = torch.from_numpy(d["R"]).to(torch.bfloat16)
    plan, B = d["plan"], d["B"]
    block_frs, truth, groups = [[] for _ in BLOCKS], [], 0
    for g0 in range(0, len(plan), GROUP):
        gplan = plan[g0 : g0 + GROUP]
        sizes = [sz for _, sz in gplan]
        lanes = sizes + [sizes[0]] * (GROUP - len(sizes))
        Xg, ys = d["group"](g0, lanes)
        masks = torch.arange(B)[None, :] < torch.tensor(lanes)[:, None]
        out = fold_program(torch.from_numpy(Xg), masks, lanes, R, True, None, **static)
        frs = tlarge.summaries_to_host(out, sizes + [0] * (GROUP - len(sizes)), False)
        for gi, (bi, sz) in enumerate(gplan):
            block_frs[bi].append(frs[gi])
            truth.append(ys[gi, :sz])
        groups += 1
    fused = tlarge.fuse_blocks(block_frs, cfg, group=len(block_frs), device=CPU)
    summaries, block_labels = [], []
    for fres in fused:
        uniq = np.unique(fres.labels)
        summaries.append((fres.cents[uniq], fres.counts[uniq]))
        block_labels.append(np.searchsorted(uniq, fres.labels))
    tf, remap, offsets, _, _ = streaming.global_block_fuse(summaries, cfg, CPU)
    parts = [remap[tf[offsets[bi] + block_labels[bi]]] for bi in range(len(summaries))]
    labels = finalize_labels(np.concatenate(parts).astype(np.int32), merge_tiny=True)
    return cfg, block_frs, fused, labels, truth, groups


@pytest.mark.parametrize("n_cells", [sum(BLOCKS), DECLARED], ids=["real", "declared_1306127"])
def test_compute_path_matches_the_jax_composition(bench_data, n_cells):
    d = bench_data
    cfg, block_frs, fused, labels, truth, groups = _port_solution(d, n_cells)
    if n_cells == DECLARED:
        assert (cfg.maxN_cluster, cfg.nc_pad) == (262, 48)
    assert groups == 3 and [len(f) for f in block_frs] == [3, 3, 3]
    np.testing.assert_array_equal(np.concatenate(truth), d["y"])

    ref_fused, ref_labels = _jax_composition(d, n_cells)
    for mine, theirs in zip(fused, ref_fused):
        np.testing.assert_array_equal(mine.labels, theirs.labels)
        assert mine.n_final == theirs.n_final
    np.testing.assert_array_equal(labels, ref_labels)
    assert len(np.unique(labels)) >= 3
    if n_cells == DECLARED:
        # every block has fewer clusters than the widened floor of 26
        assert max(tlarge._prepare_block(frs, cfg).NC for frs in block_frs) < 26


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
    """The default workload: 1,306,127 cells x 27,998 genes, 38 types, in
    26 blocks, the last 56,127 cells; the quick one: one block of 65,536."""
    for k in list(os.environ):
        if k.startswith("SHARP_BENCH_"):
            monkeypatch.delenv(k)
    env = bench_torch._bench_env()
    assert env["n_cells"] == 1306127 and env["n_genes"] == 27998 and env["n_types"] == 38
    assert (env["K"], env["p"], env["fold"], env["min_ari"]) == (5, 256, 2000, 0.80)
    assert env["blocks"] == [50000] * 25 + [56127]
    monkeypatch.setenv("SHARP_BENCH_QUICK", "1")
    quick = bench_torch._bench_env()
    assert quick["blocks"] == [65536] and (quick["n_types"], quick["min_ari"]) == (12, 0.95)


def test_quality_and_api_gates():
    """The API path's gates: a subset under 1e6 cells is held to ARI 0.95,
    the whole run to the configured floor; at most ceil(1.5 types)
    clusters."""
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
