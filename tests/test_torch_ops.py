"""Parity of the port's ops (sharp_tpu_torch.ops) with the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX function and its port.
Where the JAX function reaches a Pallas kernel, it runs in interpret mode.
Tolerances: float32 results that take the same operations in another
order or with fused multiply-adds (XLA on the CPU contracts a*b+c, torch's
separate ops do not) agree to a few ulps, hence rtol 1e-6 / atol 1e-6;
merge sequences and cuts are integers and must be identical on tie-free
data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharp_tpu.ops import distance as jdist
from sharp_tpu.ops import linkage as jlink
from sharp_tpu.ops import rp as jrp
from sharp_tpu.ops import select as jsel
from sharp_tpu.ops import silhouette as jsil
from sharp_tpu.ops.linkage_pallas import cutree_multi_pallas, ward_linkage_pallas
from sharp_tpu_torch.ops import distance as tdist
from sharp_tpu_torch.ops import linkage as tlink
from sharp_tpu_torch.ops import rp as trp
from sharp_tpu_torch.ops import select as tsel
from sharp_tpu_torch.ops import silhouette as tsil
from sharp_tpu_torch.ops.linkage_cuda import (
    LAUNCHES,
    cutree_multi_kernel,
    cutree_snapshots_kernel,
    ward_linkage_serial,
)
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _features(K, n, nreal, p, seed):
    rng = np.random.default_rng(seed)
    X = np.zeros((K, n, p), np.float32)
    X[:, :nreal] = rng.normal(size=(K, nreal, p))
    return X, np.arange(n) < nreal


def _jax_distance(X, mask):
    m = jnp.asarray(mask)
    f = lambda x: jdist.pearson_distance(jdist.standardize_rows(x, m), m)
    return np.asarray(jax.vmap(f)(jnp.asarray(X)))


@pytest.mark.parametrize("log_transform", [False, True])
def test_rp_project_ensemble_matches_jax(log_transform):
    rng = np.random.default_rng(0)
    K, n, genes, p = 3, 40, 300, 17
    X = rng.lognormal(size=(n, genes)).astype(np.float32)
    R = np.asarray(jrp.ensemble_rp_matrix(jax.random.PRNGKey(3), K, genes, p))
    ref = np.asarray(
        jrp.rp_project_ensemble(jnp.asarray(X), jnp.asarray(R), K=K, log_transform=log_transform)
    )
    got = trp.rp_project_ensemble(_t(X), _t(R), K=K, log_transform=log_transform)
    assert got.shape == (K, n, p)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    ref1 = np.asarray(jrp.rp_project(jnp.asarray(X), jnp.asarray(R[:, :p]), log_transform=log_transform))
    got1 = trp.rp_project(_t(X), _t(R[:, :p]), log_transform=log_transform)
    np.testing.assert_allclose(got1.numpy(), ref1, rtol=1e-5, atol=1e-5)


def test_ternary_rp_matrix_distribution():
    """The port draws its own RP matrices: same support, density ~1/sqrt(m)."""
    m, p = 10000, 64
    R = trp.ternary_rp_matrix(torch.Generator().manual_seed(0), m, p).numpy()
    root_s = np.float32(np.sqrt(np.sqrt(np.float32(m))))
    assert set(np.unique(R)) <= {-root_s, 0.0, root_s}
    assert abs((R != 0).mean() - 1 / np.sqrt(m)) < 0.003
    Rall = trp.ensemble_rp_matrix(7, 3, 500, 20, device="cpu")
    np.testing.assert_array_equal(Rall.numpy(), trp.ensemble_rp_matrix(7, 3, 500, 20, device="cpu").numpy())
    assert Rall.shape == (500, 60)


@pytest.mark.parametrize("G", [1, 3])
def test_block_projects_with_the_log_inside_the_call(monkeypatch, G):
    """cluster_block_ensemble hands the raw cells and log_transform to the
    module's rp_project_ensemble, and the projection is the one of the log
    taken first and projected without it, bit for bit; on the CPU the
    operand kernel is not launched."""
    from sharp_tpu_torch.core import block

    rng = np.random.default_rng(4)
    K, n_pad, genes, p = 3, 64, 90, 12
    X = torch.from_numpy(rng.lognormal(size=(G, n_pad, genes)).astype(np.float32))
    R = trp.ensemble_rp_matrix(5, K, genes, p, device="cpu")
    mask = torch.ones((G, n_pad), dtype=torch.bool)
    seen = []

    def spy(*a, **k):
        seen.append(dict(k))
        out = trp.rp_project_ensemble(*a, **k)
        seen[-1]["proj"] = out
        return out

    monkeypatch.setattr(block, "rp_project_ensemble", spy)
    before = trp.LAUNCHES["rp_operand"]
    block.cluster_block_ensemble(X, mask, [n_pad] * G, R, 6, True, K=K, ncand=5, nc_pad=8)
    assert len(seen) == 1 and seen[0]["log_transform"] is True and seen[0]["K"] == K
    old = trp.rp_project_ensemble(trp.log2p1(X).reshape(G * n_pad, genes), R, K=K)
    assert torch.equal(seen[0]["proj"], old)
    assert trp.LAUNCHES["rp_operand"] == before == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("genes", [90, 96, 27998])
def test_rp_operand_plain_on_cpu(dtype, genes):
    """The operand on the CPU is the plain version: log2p1(X).to(dtype) with
    the genes padded by zero columns to a multiple of 8; the CPU projection
    with a 16-bit R keeps the float32 route and counts its rows."""
    from torch.profiler import profile

    from sharp_tpu_torch.utils import timers

    rng = np.random.default_rng(genes)
    X = torch.from_numpy(rng.lognormal(size=(5, genes)).astype(np.float32))
    got = trp.rp_operand(X, dtype, True)
    assert got.dtype == dtype and got.shape == (5, -(-genes // 8) * 8)
    assert torch.equal(got[:, :genes], trp.log2p1(X).to(dtype))
    assert torch.equal(trp.rp_operand(X, dtype, False)[:, :genes], X.to(dtype))
    assert not got[:, genes:].any()
    R = trp.ensemble_rp_matrix(1, 2, genes, 4, dtype=dtype, device="cpu")
    timers.reset()
    with profile():
        proj = trp.rp_project_ensemble(X, R, K=2, log_transform=True)
    sums = timers.snapshot()["sums"]
    assert sums["rp.float32_rows"] == 5 and "rp.tensor_core_rows" not in sums
    ref = torch.matmul(trp.log2p1(X).to(dtype).float(), R.float()) * torch.tensor(4.0).rsqrt()
    assert torch.equal(proj, ref.reshape(5, 2, 4).permute(1, 0, 2))


def test_padded_rp_rows_made_once_per_matrix():
    """R's rows padded with zeros to the operand's: one copy for an R while
    it lives and is not written; a write or another R makes a new one, and
    the copy goes with its R."""
    import gc

    R = trp.ensemble_rp_matrix(3, 2, 61, 4, device="cpu")
    assert trp._padded_rows(R, 61) is R
    Rp = trp._padded_rows(R, 64)
    assert Rp.shape == (64, 8) and torch.equal(Rp[:61], R) and not Rp[61:].any()
    assert trp._padded_rows(R, 64) is Rp
    R.mul_(2)
    Rp2 = trp._padded_rows(R, 64)
    assert Rp2 is not Rp and torch.equal(Rp2[:61], R)
    other = R.clone()
    assert trp._padded_rows(other, 64) is not Rp2
    del R, other, Rp, Rp2
    gc.collect()
    assert torch.device("cpu") not in trp._PADDED


def test_distances_match_jax_with_pad_tiers():
    X, mask = _features(2, 64, 50, 24, seed=1)
    Z_ref = np.asarray(jax.vmap(lambda x: jdist.standardize_rows(x, jnp.asarray(mask)))(jnp.asarray(X)))
    Z = tdist.standardize_rows(_t(X), _t(mask))
    np.testing.assert_allclose(Z.numpy(), Z_ref, atol=1e-6)
    D_ref = _jax_distance(X, mask)
    D = tdist.pearson_distance(Z, _t(mask))
    np.testing.assert_allclose(D.numpy(), D_ref, atol=1e-6, rtol=0)
    assert (D.numpy()[:, 50:, 50:][:, ~np.eye(14, dtype=bool)] == np.float32(tdist.PAD_PAD_DIST)).all()
    assert (D.numpy()[:, :50, 50:] == np.float32(tdist.PAD_REAL_DIST)).all()
    assert (np.diagonal(D.numpy(), axis1=1, axis2=2) == 0).all()

    rng = np.random.default_rng(2)
    S = rng.random((32, 32)).astype(np.float32)
    S = (S + S.T) / 2
    smask = np.arange(32) < 27
    S_ref = np.asarray(jdist.similarity_to_distance(jnp.asarray(S), jnp.asarray(smask)))
    np.testing.assert_allclose(
        tdist.similarity_to_distance(_t(S), _t(smask)).numpy(), S_ref, atol=1e-6, rtol=0
    )


@pytest.mark.parametrize("method", tlink.HMETHODS)
def test_lw_update_all_methods(method):
    rng = np.random.default_rng(3)
    dik, djk = rng.random((2, 50)).astype(np.float32)
    nk = rng.integers(1, 9, 50).astype(np.float32)
    h, ni, nj = np.float32(0.05), np.float32(3), np.float32(5)
    ref = np.asarray(jlink.lw_update(method, jnp.asarray(dik), jnp.asarray(djk), h, ni, nj, jnp.asarray(nk)))
    got = tlink.lw_update(method, _t(dik), _t(djk), torch.tensor(h), torch.tensor(ni), torch.tensor(nj), _t(nk))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("K,n,nreal", [(3, 128, 110), (1, 64, 50)])
def test_ward_linkage_matches_jax_and_pallas(K, n, nreal):
    X, mask = _features(K, n, nreal, 24, seed=0)
    D = _jax_distance(X, mask)
    got = tlink.ward_linkage(_t(D))
    ref = jax.vmap(jlink.ward_linkage)(jnp.asarray(D))
    pal = ward_linkage_pallas(jnp.asarray(D), interpret=True)
    for r in (ref, pal):
        np.testing.assert_array_equal(
            got.merges.numpy()[:, : nreal - 1], np.asarray(r.merges)[:, : nreal - 1]
        )
        np.testing.assert_allclose(
            got.heights.numpy()[:, : nreal - 1], np.asarray(r.heights)[:, : nreal - 1], rtol=1e-6
        )
    # the wrapper takes the plain loop for a CPU tensor, launching nothing
    before = LAUNCHES["ward_serial"]
    ser = ward_linkage_serial(_t(D))
    assert LAUNCHES["ward_serial"] == before
    np.testing.assert_array_equal(ser.merges.numpy(), got.merges.numpy())
    np.testing.assert_array_equal(ser.heights.numpy(), got.heights.numpy())


@pytest.mark.parametrize("method", ["average", "centroid", "single"])
def test_general_linkage_matches_jax(method):
    X, mask = _features(1, 64, 60, 16, seed=4)
    D = _jax_distance(X, mask)[0]
    ref = jlink.ward_linkage(jnp.asarray(D), method=method)
    got = tlink.ward_linkage(_t(D), method=method)
    np.testing.assert_array_equal(got.merges.numpy()[:59], np.asarray(ref.merges)[:59])
    np.testing.assert_allclose(got.heights.numpy()[:59], np.asarray(ref.heights)[:59], rtol=1e-6)


def test_cutree_multi_matches_pallas():
    n, nreal = 128, 120
    X, mask = _features(1, n, nreal, 24, seed=3)
    D = _jax_distance(X, mask)[0]
    merges = np.asarray(jlink.ward_linkage(jnp.asarray(D)).merges)
    kw = dict(minN=2, ncand=13, nc_pad=16)
    ref = cutree_multi_pallas(
        jnp.asarray(merges), jnp.asarray(nreal), jnp.asarray(mask), jnp.asarray(40),
        interpret=True, **kw,
    )
    ref_xla = jlink.cutree_multi(
        jnp.asarray(merges), jnp.asarray(nreal), jnp.asarray(mask), jnp.asarray(40), **kw
    )
    got = tlink.cutree_multi(_t(merges), nreal, _t(mask), 40, **kw)
    for r in (ref, ref_xla):
        for a, b in zip(got, r):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    before = LAUNCHES["cutree"]
    wrapped = cutree_multi_kernel(_t(merges), nreal, _t(mask), 40, **kw)
    assert LAUNCHES["cutree"] == before
    for a, b in zip(wrapped, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cutree_batched_per_problem_counts():
    """Each problem of a batch replays with its own n_real."""
    K, n = 3, 96
    X, _ = _features(K, n, n, 16, seed=4)
    mask = np.ones(n, bool)
    D = _jax_distance(X, mask)
    merges = np.asarray(jax.vmap(jlink.ward_linkage)(jnp.asarray(D)).merges)
    nr = [96, 90, 80]
    got = tlink.cutree_multi(_t(merges), nr, _t(mask), 20, minN=2, ncand=7, nc_pad=16)
    for g in range(K):
        ref = jlink.cutree_multi(
            jnp.asarray(merges[g]), jnp.asarray(nr[g]), jnp.asarray(mask), jnp.asarray(20),
            minN=2, ncand=7, nc_pad=16,
        )
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy()[g], np.asarray(b))


def test_real_heights_tail_and_median_match_jax():
    rng = np.random.default_rng(5)
    h = np.sort(rng.random(63).astype(np.float32))
    for nreal in (5, 40, 64):
        w_ref, v_ref = jlink.real_heights_tail(jnp.asarray(h), jnp.asarray(nreal))
        w, v = tlink.real_heights_tail(_t(h), nreal)
        np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    x = rng.random(30).astype(np.float32)
    m = rng.random(30) < 0.7
    ref = jsil.masked_median(jnp.asarray(x), jnp.asarray(m), jnp.asarray(int(m.sum())))
    assert float(tsil.masked_median(_t(x), _t(m), int(m.sum()))) == float(ref)


def _blobs(n, p, k, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    C = rng.normal(size=(k, p))
    return (scale * C[y] + 0.5 * rng.normal(size=(n, p))).astype(np.float32)


@pytest.mark.parametrize("symmetric", [False, True])
def test_opt_hclust_matches_jax(symmetric):
    n_pad, nreal = 128, 100
    feats = _blobs(nreal, 20, 5, seed=6)
    if symmetric:
        U = feats - feats.mean(1, keepdims=True)
        U /= np.linalg.norm(U, axis=1, keepdims=True)
        mat = np.zeros((n_pad, n_pad), np.float32)
        mat[:nreal, :nreal] = U @ U.T
    else:
        mat = np.zeros((n_pad, 20), np.float32)
        mat[:nreal] = feats
    mask = np.arange(n_pad) < nreal
    kw = dict(symmetric=symmetric, minN=2, ncand=39, nc_pad=48, sil_thre=0.35, height_Ntimes=2.0)
    ref = jsel.opt_hclust(
        jnp.asarray(mat), jnp.asarray(mask), jnp.asarray(nreal), jnp.asarray(40), **kw
    )
    got = tsel.opt_hclust(_t(mat), _t(mask), nreal, 40, **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    assert int(got.k) == int(ref.k)
    assert int(got.oind) == int(ref.oind)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.all_labels.numpy(), np.asarray(ref.all_labels))
    np.testing.assert_allclose(got.msil.numpy(), np.asarray(ref.msil), atol=1e-5)
    # CH reaches ~1e4, where one float32 ulp is ~1e-3, so it is held
    # relative: its within-cluster dispersion sums 1 - corr terms near 0,
    # which turns a last-bit difference of corr into ~1e-5 relative
    np.testing.assert_allclose(got.ch.numpy(), np.asarray(ref.ch), rtol=1e-4)
    assert float(got.maxsil) == pytest.approx(float(ref.maxsil), abs=1e-5)


@pytest.mark.parametrize("kw", [{}, {"N_cluster": 4}, {"sil_thre": 0.99}])
def test_get_opt_hclust_matches_jax(kw):
    feats = _blobs(90, 12, 4, seed=7)
    ref = jsel.get_opt_hclust(feats, **kw)
    got = tsel.get_opt_hclust(feats, device="cpu", **kw)
    for key in ("f", "v"):
        np.testing.assert_array_equal(got[key], ref[key])
    for key in ("optN_cluster", "oind"):
        assert got[key] == ref[key]
    np.testing.assert_allclose(got["msil"], ref["msil"], atol=1e-5)
    np.testing.assert_allclose(got["CHind"], ref["CHind"], rtol=1e-4)  # as above
    np.testing.assert_allclose(got["height"], ref["height"], rtol=1e-6, atol=1e-6)


def test_resolve_linkage_backend():
    assert tlink.resolve_linkage_backend("auto", 512) == "serial"
    assert tlink.resolve_linkage_backend("xla", 128) == "serial"
    assert tlink.resolve_linkage_backend("pallas", 1024) == "serial"
    assert tlink.resolve_linkage_backend("auto", 512, "average") == "plain"
    # above the serial kernel's 1024: the ladder, with f32 storage
    assert tlink.resolve_linkage_backend("auto", 2048) == "rnn"
    assert tlink.resolve_linkage_backend("pallas", 1536) == "rnn"
    assert tlink.resolve_linkage_backend("auto", 2048, "average") == "plain"
    for backend in ("rnn", "rnn_bf16"):
        assert tlink.resolve_linkage_backend(backend, 256) == backend
        assert tlink.resolve_linkage_backend(backend, 2048) == backend
        with pytest.raises(ValueError, match="ward.D only"):
            tlink.resolve_linkage_backend(backend, 512, "average")
    # serial Ward with bf16 storage at every size, as the JAX package runs it
    assert tlink.resolve_linkage_backend("pallas_bf16", 512) == "serial_bf16"
    assert tlink.resolve_linkage_backend("pallas_bf16", 2048) == "serial_bf16"
    with pytest.raises(ValueError, match="ward.D only"):
        tlink.resolve_linkage_backend("pallas_bf16", 512, "average")
    with pytest.raises(ValueError):
        tlink.resolve_linkage_backend("pallas", 512, "average")
    with pytest.raises(ValueError):
        tlink.resolve_linkage_backend("bogus", 512)


def test_wrappers_refuse_other_devices():
    D = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        ward_linkage_serial(D)
    with pytest.raises(ValueError, match="device"):
        cutree_snapshots_kernel(torch.zeros((1, 3, 2), dtype=torch.int32, device="meta"), 4, minN=2, ncand=2)
