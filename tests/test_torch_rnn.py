"""Parity of the port's reciprocal-NN ladder and its tail with the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX functions and their ports;
the JAX tail kernel runs in interpret mode. Merge indices are integers and
must be identical. Heights are float32 results of the same operations that
XLA on the CPU may contract into fused multiply-adds, which torch's separate
ops do not: they agree within rtol 1e-6 (the tolerance of
tests/test_torch_ops.py). Only real merges are compared against JAX: the
padded points merge among themselves at exactly tied heights near 1e20,
where one ulp of that contraction reorders the ties. On the card the tail
kernel is held bit for bit against the plain `rnn_tail`
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharp_tpu.ops import distance as jdist
from sharp_tpu.ops import linkage as jlink
from sharp_tpu.ops.linkage_pallas import rnn_tail_pallas
from sharp_tpu_torch.ops import linkage as tlink
from sharp_tpu_torch.ops.linkage_cuda import LAUNCHES, rnn_tail_kernel
from torch_threads import one_torch_thread  # noqa: F401

STORES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _distance(n, nreal, p, seed, dup=0):
    """Pearson distances with pad tiers; `dup` real points repeat point 0
    (exact ties)."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, p), np.float32)
    X[:nreal] = rng.normal(size=(nreal, p))
    X[1 : 1 + dup] = X[0]
    m = jnp.asarray(np.arange(n) < nreal)
    return np.array(jdist.pearson_distance(jdist.standardize_rows(jnp.asarray(X), m), m))


def _tail_inputs(L, Cn, seed):
    """Compacted-tail-like lanes: the first n_alive slots live, dead slots
    and the diagonal BIG, cluster sizes > 1, running heights, increasing
    global indices, and a few duplicated points per lane."""
    rng = np.random.default_rng(seed)
    D = np.empty((L, Cn, Cn), np.float32)
    alive = np.zeros((L, Cn), np.float32)
    n_alive = [Cn, Cn - 7, Cn // 2 + 3][:L]
    for lane, na in enumerate(n_alive):
        D[lane] = _distance(Cn, na, 16, seed + lane, dup=3)
        alive[lane, :na] = 1.0
        dead = np.arange(Cn) >= na
        D[lane][dead, :] = jlink.BIG
        D[lane][:, dead] = jlink.BIG
        np.fill_diagonal(D[lane], jlink.BIG)
    sizes = rng.integers(1, 6, (L, Cn)).astype(np.float32)
    lasth = (rng.random((L, Cn)) * 0.05).astype(np.float32)
    gidx = np.sort(rng.choice(4 * Cn, (L, Cn)), axis=1).astype(np.int32)
    return D, alive, sizes, gidx, lasth, np.array(n_alive)


@pytest.fixture(scope="module", params=[64, 128])
def tail_case(request):
    Cn = request.param
    D, alive, sizes, gidx, lasth, n_alive = _tail_inputs(3, Cn, seed=Cn)
    refs = {}
    for name, (_, jst) in STORES.items():
        Dst = jnp.asarray(D).astype(jst)
        refs[name] = jax.vmap(lambda *a: rnn_tail_pallas(*a, interpret=True))(
            Dst, jnp.asarray(alive), jnp.asarray(sizes), jnp.asarray(gidx), jnp.asarray(lasth)
        )
    return dict(D=D, alive=alive, sizes=sizes, gidx=gidx, lasth=lasth, n_alive=n_alive, refs=refs)


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_rnn_tail_matches_pallas(tail_case, store):
    c = tail_case
    tst, _ = STORES[store]
    args = [torch.from_numpy(c[k]) for k in ("alive", "sizes", "gidx", "lasth")]
    D = torch.from_numpy(c["D"]).to(tst)
    before = LAUNCHES["rnn_tail"]
    got = rnn_tail_kernel(D, *args)   # a CPU tensor takes the plain version
    assert LAUNCHES["rnn_tail"] == before
    plain = tlink.rnn_tail(D, *args)
    mi, mj, hh = (np.asarray(x) for x in c["refs"][store])
    for lane, na in enumerate(c["n_alive"]):
        t = na - 1
        np.testing.assert_array_equal(got[0][lane, :t].numpy(), mi[lane, :t])
        np.testing.assert_array_equal(got[1][lane, :t].numpy(), mj[lane, :t])
        np.testing.assert_allclose(got[2][lane, :t].numpy(), hh[lane, :t], rtol=1e-6)
        for a, b in zip(got, plain):
            assert torch.equal(a[lane, :t], b[lane, :t])


def _cuts(merges, nreal, n):
    mask = np.arange(n) < nreal
    return jlink.cutree_multi(
        jnp.asarray(np.asarray(merges)), jnp.asarray(nreal), jnp.asarray(mask), jnp.asarray(40),
        minN=2, ncand=39, nc_pad=48,
    ).labels


@pytest.fixture(scope="module", params=[(128, 110), (256, 230)])
def ladder_case(request):
    n, nreal = request.param
    D = _distance(n, nreal, 24, seed=n)
    Dj = jnp.asarray(D)
    return dict(
        n=n, nreal=nreal, D=D,
        rnn=jlink.ward_linkage_rnn(Dj, tail="pallas_interpret", compact_n=64),
        rnn_bf16=jlink.ward_linkage_rnn(
            Dj, tail="pallas_interpret", compact_n=64, store_dtype=jnp.bfloat16
        ),
        serial=jlink.ward_linkage(Dj),
    )


@pytest.mark.parametrize("ref", ["rnn", "serial"])
def test_ward_linkage_rnn_matches_jax(ladder_case, ref):
    c = ladder_case
    k = c["nreal"] - 1
    got = tlink.ward_linkage_rnn(torch.from_numpy(c["D"]), compact_n=64, compact_cap=32)
    r = c[ref]
    np.testing.assert_array_equal(got.merges.numpy()[:k], np.asarray(r.merges)[:k])
    np.testing.assert_allclose(got.heights.numpy()[:k], np.asarray(r.heights)[:k], rtol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(_cuts(got.merges.numpy(), c["nreal"], c["n"])),
        np.asarray(_cuts(r.merges, c["nreal"], c["n"])),
    )
    assert tlink.validate_merge_sequence(got.merges, got.heights, c["nreal"], c["n"]) == []


def test_ward_linkage_rnn_bf16_matches_jax(ladder_case):
    c = ladder_case
    k = c["nreal"] - 1
    got = tlink.ward_linkage_rnn(
        torch.from_numpy(c["D"]), compact_n=64, store_dtype=torch.bfloat16
    )
    r = c["rnn_bf16"]
    np.testing.assert_array_equal(got.merges.numpy()[:k], np.asarray(r.merges)[:k])
    np.testing.assert_allclose(got.heights.numpy()[:k], np.asarray(r.heights)[:k], rtol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(_cuts(got.merges.numpy(), c["nreal"], c["n"])),
        np.asarray(_cuts(r.merges, c["nreal"], c["n"])),
    )


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_batched_lanes_behave_as_separate_calls(store):
    """Lanes of one batched ladder with different real counts (so their
    levels take different numbers of rounds) give, bit for bit, what each
    gives alone."""
    tst, _ = STORES[store]
    n = 256
    D = np.stack([_distance(n, nr, 20, seed=nr, dup=2) for nr in (256, 200, 130, 40)])
    both = tlink.ward_linkage_rnn(torch.from_numpy(D), compact_n=64, store_dtype=tst)
    for lane in range(D.shape[0]):
        one = tlink.ward_linkage_rnn(torch.from_numpy(D[lane]), compact_n=64, store_dtype=tst)
        assert torch.equal(both.merges[lane], one.merges)
        assert torch.equal(both.heights[lane], one.heights)


def test_ward_linkage_rnn_without_ladder_is_serial():
    """A problem no larger than compact_n skips the ladder: the tail alone
    gives the serial merge order."""
    D = _distance(64, 60, 12, seed=3)
    got = tlink.ward_linkage_rnn(torch.from_numpy(D))
    ref = tlink.ward_linkage(torch.from_numpy(D))
    assert torch.equal(got.merges[:59], ref.merges[:59])
    np.testing.assert_allclose(got.heights[:59].numpy(), ref.heights[:59].numpy(), rtol=1e-6)


def test_validate_merge_sequence_flags_faults():
    D = _distance(64, 50, 12, seed=4)
    link = tlink.ward_linkage_rnn(torch.from_numpy(D), compact_n=32)
    assert tlink.validate_merge_sequence(link.merges, link.heights, 50, 64) == []
    bad = link.merges.clone()
    bad[5] = bad[4]
    errs = tlink.validate_merge_sequence(bad, link.heights, 50, 64)
    assert any("duplicated" in e for e in errs) and any("replay" in e for e in errs)
    drop = link.heights.clone()
    drop[10] = 0.0
    assert any("drops" in e for e in tlink.validate_merge_sequence(link.merges, drop, 50, 64))
