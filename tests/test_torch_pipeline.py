"""Parity of the port's small-tier pipeline with the JAX package, on the CPU.

Both packages get the same seeded numpy data and the same random draws:
the JAX package makes the RP matrices and the testlog probe, and the port
takes them through `sharp_tpu_torch.carry`. Labels, per-member cluster
counts and cuts are integers and must be identical; float32 scores agree
to a few ulps of their magnitude (atol 1e-5 on silhouettes in [-1, 1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharp_tpu
import sharp_tpu_torch
from sharp_tpu.config import resolve_config
from sharp_tpu.core.block import cluster_block_ensemble as j_block
from sharp_tpu.core.pipeline import testlog_decide as j_testlog
from sharp_tpu.core.wmetac import wmetac as j_wmetac
from sharp_tpu.ops.rp import ensemble_rp_matrix, ternary_rp_matrix
from sharp_tpu.utils import prng as jprng
from sharp_tpu_torch import carry
from sharp_tpu_torch.core.block import cluster_block_ensemble as t_block
from sharp_tpu_torch.core.pipeline import testlog_decide as t_testlog
from sharp_tpu_torch.core.wmetac import wmetac as t_wmetac
from tests.synth import make_tpm_like
from torch_threads import one_torch_thread  # noqa: F401


def _jax_draws(n, genes, K, p, rN_seed):
    key = jprng.seed_to_key(rN_seed)
    R = np.asarray(ensemble_rp_matrix(key, K, genes, p))
    perm = np.asarray(jax.random.permutation(jprng.testlog_key(key), n, independent=True))
    R_probe = np.asarray(ternary_rp_matrix(jax.random.PRNGKey(5), genes, p))
    return R, perm, R_probe


@pytest.fixture(scope="module")
def block_case():
    """One padded block (n=200 real of 256, 300 genes, K=5) through both
    packages' cluster_block_ensemble."""
    n, genes, K, n_pad = 200, 300, 5, 256
    X, y = make_tpm_like(n_cells=n, n_genes=genes, n_types=4, seed=5)
    cfg = resolve_config(n, genes, ensize_K=K)
    R, _, _ = _jax_draws(n, genes, K, cfg.reduced_ndim, 42)
    Xp = np.zeros((n_pad, genes), np.float32)
    Xp[:n] = X
    mask = np.arange(n_pad) < n
    kw = dict(
        K=K, minN=2, ncand=cfg.maxN_cluster - 1, nc_pad=cfg.nc_pad,
        sil_thre=cfg.sil_thre, height_Ntimes=cfg.height_Ntimes,
    )
    ref = j_block(
        jnp.asarray(Xp), jnp.asarray(mask), jnp.asarray(n), jnp.asarray(R),
        jnp.asarray(cfg.maxN_cluster), jnp.asarray(True), **kw,
    )
    got = t_block(
        torch.from_numpy(Xp), torch.from_numpy(mask), n,
        carry.rp_from_jax(R, K, cfg.reduced_ndim, device="cpu"), cfg.maxN_cluster, True, **kw,
    )
    return dict(n=n, K=K, cfg=cfg, mask=mask, ref=ref, got=got)


def test_cluster_block_ensemble_matches_jax(block_case):
    ref, got = block_case["ref"], block_case["got"]
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(got.k_per.numpy(), np.asarray(ref.k_per))
    np.testing.assert_allclose(got.maxsil.numpy(), np.asarray(ref.maxsil), atol=1e-5)
    np.testing.assert_allclose(got.mean_proj.numpy(), np.asarray(ref.mean_proj), rtol=1e-5, atol=1e-4)


def test_wmetac_matches_jax(block_case):
    cfg, K, n, mask = block_case["cfg"], block_case["K"], block_case["n"], block_case["mask"]
    labels = np.array(block_case["ref"].labels)
    kw = dict(
        K=K, nc_pad=cfg.nc_pad, allc_pad=256, meta_minN=2,
        meta_ncand=cfg.maxN_cluster - 1, sil_thre=0.0, height_Ntimes=2.0,
    )
    ref = j_wmetac(
        jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(n),
        jnp.asarray(cfg.maxN_cluster), **kw,
    )
    got = t_wmetac(torch.from_numpy(labels), torch.from_numpy(mask), n, cfg.maxN_cluster, **kw)
    np.testing.assert_array_equal(got.finalC.numpy(), np.asarray(ref.finalC))
    np.testing.assert_array_equal(got.tf.numpy(), np.asarray(ref.tf))
    assert int(got.n_meta) == int(ref.n_meta)
    assert int(got.allC) == int(ref.allC)
    assert bool(got.overflow) == bool(ref.overflow)
    np.testing.assert_allclose(got.x0.numpy(), np.asarray(ref.x0), atol=1e-6)


def test_wmetac_single_cluster_fallback_matches_jax():
    """Members that all agree on one cluster except a few cells: the
    runner-up vote rule (R/wMetaC.R:147-161) decides both packages alike."""
    n_pad, n, K, nc_pad = 64, 60, 4, 16
    rng = np.random.default_rng(0)
    labels = np.zeros((n_pad, K), np.int32)
    labels[rng.choice(n, 6, replace=False), 1] = 1
    labels[n:] = nc_pad - 1
    mask = np.arange(n_pad) < n
    kw = dict(K=K, nc_pad=nc_pad, allc_pad=64, meta_minN=2, meta_ncand=13)
    ref = j_wmetac(jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(n), jnp.asarray(14), **kw)
    got = t_wmetac(torch.from_numpy(labels), torch.from_numpy(mask), n, 14, **kw)
    np.testing.assert_array_equal(got.finalC.numpy(), np.asarray(ref.finalC))
    assert int(got.n_meta) == int(ref.n_meta)


def test_testlog_decide_matches_jax():
    n, genes = 150, 300
    X, _ = make_tpm_like(n_cells=n, n_genes=genes, n_types=3, seed=2)
    cfg = resolve_config(n, genes)
    _, perm, R_probe = _jax_draws(n, genes, 1, cfg.reduced_ndim, 3)
    ref = j_testlog(X, cfg, jprng.seed_to_key(3))
    probe = carry.testlog_probe_from_jax(perm, R_probe, n, genes, cfg.reduced_ndim, device="cpu")
    assert t_testlog(torch.from_numpy(X), cfg, 3, probe=probe) == ref


@pytest.mark.parametrize(
    "n,genes,types,seed,rN_seed",
    [(300, 400, 4, 8, 11), (150, 400, 3, 7, 1)],
)
def test_sharp_end_to_end_matches_jax(n, genes, types, seed, rN_seed):
    X, y = make_tpm_like(n_cells=n, n_genes=genes, n_types=types, seed=seed)
    kw = dict(rN_seed=rN_seed, ensize_K=5, prep=False)
    cfg = resolve_config(n, genes, **kw)
    R, perm, R_probe = _jax_draws(n, genes, 5, cfg.reduced_ndim, rN_seed)
    ref = sharp_tpu.sharp(X, **kw)
    got = sharp_tpu_torch.sharp(
        X,
        rM=carry.rp_from_jax(R, 5, cfg.reduced_ndim, device="cpu"),
        testlog_probe=carry.testlog_probe_from_jax(perm, R_probe, n, genes, cfg.reduced_ndim, device="cpu"),
        device="cpu",
        **kw,
    )
    np.testing.assert_array_equal(got.pred_clusters, ref.pred_clusters)
    np.testing.assert_array_equal(got.per_member_k, ref.per_member_k)
    np.testing.assert_allclose(got.per_member_maxsil, ref.per_member_maxsil, atol=1e-5)
    np.testing.assert_allclose(got.x0, ref.x0, atol=1e-6)
    np.testing.assert_allclose(got.viE, ref.viE, rtol=1e-5, atol=1e-4)
    assert got.N_pred_cluster == ref.N_pred_cluster
    assert got.distr_pred_clusters == ref.distr_pred_clusters
    assert [s["stage"] for s in got.timing["stages"]] == [
        "preprocess", "stage_rp_setup", "log_decision", "ensemble_cluster", "wmetac", "finalize",
    ]


def test_sharp_knobs_on_cpu():
    """The port's own draws: reproducible per seed, fixed N_cluster honored,
    the genes-by-cells orientation accepted, rM shape checked."""
    X, y = make_tpm_like(n_cells=150, n_genes=300, n_types=3, seed=9)
    r1 = sharp_tpu_torch.sharp(X, rN_seed=5, ensize_K=3, device="cpu")
    r2 = sharp_tpu_torch.sharp(X.T, rN_seed=5, ensize_K=3, device="cpu", cells_axis=1)
    np.testing.assert_array_equal(r1.pred_clusters, r2.pred_clusters)
    u = np.unique(r1.pred_clusters)
    assert np.array_equal(u, np.arange(1, len(u) + 1))
    r3 = sharp_tpu_torch.sharp(X, rN_seed=1, ensize_K=3, N_cluster=3, device="cpu")
    assert r3.N_pred_cluster == 3
    with pytest.raises(ValueError, match="rM has shape"):
        sharp_tpu_torch.sharp(X, rM=np.zeros((300, 7), np.float32), ensize_K=3, device="cpu")


def test_alternative_hmethod_matches_jax():
    """A non-ward hmethod takes the plain loop on both devices."""
    n, genes = 150, 400
    X, y = make_tpm_like(n_cells=n, n_genes=genes, n_types=3, seed=7)
    kw = dict(rN_seed=1, ensize_K=4, hmethod="average", prep=False)
    cfg = resolve_config(n, genes, **kw)
    R, perm, R_probe = _jax_draws(n, genes, 4, cfg.reduced_ndim, 1)
    ref = sharp_tpu.sharp(X, **kw)
    got = sharp_tpu_torch.sharp(
        X, rM=R, device="cpu",
        testlog_probe=carry.testlog_probe_from_jax(perm, R_probe, n, genes, cfg.reduced_ndim, device="cpu"),
        **kw,
    )
    np.testing.assert_array_equal(got.pred_clusters, ref.pred_clusters)
    np.testing.assert_array_equal(got.per_member_k, ref.per_member_k)


def test_run_mtimes_grid_and_summary():
    X, y = make_tpm_like(n_cells=120, n_genes=300, n_types=3, seed=11)
    grid = sharp_tpu_torch.run_mtimes(X, mtimes=2, k_set=(3,), rN_seed=4, device="cpu")
    assert len(grid) == 1 and len(grid[0]) == 2
    assert [r.paras["rN_seed"] for r in grid[0]] == [4, 5]
    summary = sharp_tpu_torch.summarize_mtimes(grid, truth=y)
    assert set(summary[3]) == {"n_clusters", "pairwise_ari_mean", "truth_ari_mean", "truth_ari_std"}
    assert summary[3]["truth_ari_mean"] >= 0.9
