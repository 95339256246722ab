"""Serial Ward with bf16 storage (`linkage_backend="pallas_bf16"`) on the
CPU, against the JAX package.

The plain loop `ward_linkage(D, store_dtype=torch.bfloat16)` is the
reference of the hand-written `ward_serial.cu` in bf16 storage; here it is
held to the JAX kernel `ward_linkage_pallas(D, store_dtype=jnp.bfloat16)`
in interpret mode, as tests/test_linkage_pallas.py runs it. Both round D to
bf16 on entry, compute the Lance-Williams row in float32 from stored
values, round it on store and take the flat first-index argmin of the
stored values, so merges and heights must be identical, ties included
(the JAX kernel's deferred column corrections carry stored values exactly).
The whole-path test runs `sharp()` on both packages with the same draws,
the JAX kernel swapped for its interpret form for the test's duration.
Each test here takes a few seconds (interpret mode at n <= 128).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharp_tpu
import sharp_tpu_torch
from sharp_tpu.config import resolve_config
from sharp_tpu.ops import distance as jdist
from sharp_tpu.ops import linkage_pallas as jpal
from sharp_tpu.ops.rp import ensemble_rp_matrix, ternary_rp_matrix
from sharp_tpu.utils import prng as jprng
from sharp_tpu_torch import carry
from sharp_tpu_torch.ops import linkage as tlink
from sharp_tpu_torch.ops.linkage_cuda import LAUNCHES, ward_linkage_serial
from tests.synth import make_tpm_like
from torch_threads import one_torch_thread  # noqa: F401


def _jax_distance(K, n, nreal, p, seed):
    """Pearson distances of K seeded problems of nreal real points padded
    to n, made by the JAX package."""
    rng = np.random.default_rng(seed)
    X = np.zeros((K, n, p), np.float32)
    X[:, :nreal] = rng.normal(size=(K, nreal, p))
    m = jnp.asarray(np.arange(n) < nreal)
    f = lambda x: jdist.pearson_distance(jdist.standardize_rows(x, m), m)
    return np.asarray(jax.vmap(f)(jnp.asarray(X)))


def _wmetac_like(n, nreal, seed, members=5, labels=6):
    """1 - (share of members that put two points in one cluster): a few
    distinct values, so ties everywhere, as wMetaC's similarities have."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, labels, (nreal, members))
    D = np.full((n, n), 1e26, np.float32)
    D[nreal:, nreal:] = 1e20
    D[:nreal, :nreal] = 1.0 - (lab[:, None, :] == lab[None, :, :]).mean(-1)
    np.fill_diagonal(D, 0.0)
    return D[None]


def _case(name):
    if name == "tied_128":
        return _wmetac_like(128, 120, seed=3), 120
    K, n, nreal = {"64_50": (1, 64, 50), "128": (1, 128, 128), "3x96": (3, 96, 96)}[name]
    return np.array(_jax_distance(K, n, nreal, 24, seed=n)), nreal


@pytest.mark.parametrize("name", ["64_50", "128", "3x96", "tied_128"])
def test_plain_bf16_store_matches_pallas_interpret(name):
    D, nreal = _case(name)
    ref = jpal.ward_linkage_pallas(jnp.asarray(D), store_dtype=jnp.bfloat16, interpret=True)
    got = tlink.ward_linkage(torch.from_numpy(D), store_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.merges.numpy(), np.asarray(ref.merges))
    np.testing.assert_array_equal(got.heights.numpy(), np.asarray(ref.heights))
    f32 = tlink.ward_linkage(torch.from_numpy(D))
    if name != "tied_128":   # bf16 rounding moves real merges on real data
        assert not np.array_equal(got.merges.numpy()[..., : nreal - 1, :], f32.merges.numpy()[..., : nreal - 1, :])
    # the wrapper takes the plain loop for a CPU tensor, launching nothing
    before = LAUNCHES["ward_serial"]
    ser = ward_linkage_serial(torch.from_numpy(D), store_dtype=torch.bfloat16)
    assert LAUNCHES["ward_serial"] == before
    assert torch.equal(ser.merges, got.merges) and torch.equal(ser.heights, got.heights)


def test_plain_loop_reads_the_upper_triangle():
    """D is taken as symmetric from its upper triangle, in both storage
    types, as the kernel reads it; a D that is not symmetric in its last
    bits gives the merges of its upper triangle's mirror."""
    D, _ = _case("3x96")
    rng = np.random.default_rng(0)
    skew = D * (1.0 + 1e-6 * rng.standard_normal(D.shape)).astype(np.float32)
    upper = np.triu(skew, 1)
    sym = upper + np.swapaxes(upper, 1, 2)
    for st in (None, torch.bfloat16):
        a = tlink.ward_linkage(torch.from_numpy(skew), store_dtype=st)
        b = tlink.ward_linkage(torch.from_numpy(sym), store_dtype=st)
        assert torch.equal(a.merges, b.merges) and torch.equal(a.heights, b.heights)
    with pytest.raises(TypeError, match="bfloat16"):
        tlink.ward_linkage(torch.from_numpy(D), store_dtype=torch.float16)


def test_sharp_pallas_bf16_matches_jax(monkeypatch):
    """The small tier with linkage_backend="pallas_bf16" (block linkage at
    n_pad 128, K 3, wMetaC, testlog probes) on both packages with the same
    draws: identical labels and per-member cluster counts."""
    from sharp_tpu_torch.ops import select as tsel

    stores = {"jax": [], "port": []}
    real_jax, real_port = jpal.ward_linkage_pallas, tsel.ward_linkage_serial

    def jax_interpreted(D, store_dtype=jnp.float32, **kw):
        stores["jax"].append((D.shape[-1], jnp.dtype(store_dtype)))
        return real_jax(D, store_dtype=store_dtype, interpret=True)

    def port(D, store_dtype=torch.float32):
        stores["port"].append((D.shape[-1], store_dtype))
        return real_port(D, store_dtype=store_dtype)

    monkeypatch.setattr(jpal, "ward_linkage_pallas", jax_interpreted)
    monkeypatch.setattr(tsel, "ward_linkage_serial", port)
    n, genes, K = 110, 300, 3
    X, y = make_tpm_like(n_cells=n, n_genes=genes, n_types=3, seed=4)
    kw = dict(rN_seed=6, ensize_K=K, prep=False, linkage_backend="pallas_bf16")
    cfg = resolve_config(n, genes, **kw)
    key = jprng.seed_to_key(6)
    R = np.asarray(ensemble_rp_matrix(key, K, genes, cfg.reduced_ndim))
    perm = np.asarray(jax.random.permutation(jprng.testlog_key(key), n, independent=True))
    R_probe = np.asarray(ternary_rp_matrix(jax.random.PRNGKey(5), genes, cfg.reduced_ndim))
    ref = sharp_tpu.sharp(X, **kw)
    got = sharp_tpu_torch.sharp(
        X,
        rM=carry.rp_from_jax(R, K, cfg.reduced_ndim, device="cpu"),
        testlog_probe=carry.testlog_probe_from_jax(perm, R_probe, n, genes, cfg.reduced_ndim, device="cpu"),
        device="cpu",
        **kw,
    )
    np.testing.assert_array_equal(got.pred_clusters, ref.pred_clusters)
    np.testing.assert_array_equal(got.per_member_k, ref.per_member_k)
    assert got.N_pred_cluster == ref.N_pred_cluster
    # the block linkage went through serial Ward in bf16 storage on both
    # sides; wMetaC and the testlog probes keep their own backend
    assert stores["jax"] == [(128, jnp.dtype(jnp.bfloat16))]
    assert [c for c in stores["port"] if c[1] == torch.bfloat16] == [(128, torch.bfloat16)]
