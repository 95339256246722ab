"""Parity of the port's ladder round with the JAX package, on the CPU.

The same numpy-made state goes through the JAX round scatter
(`rnn_round_scatter`, run in interpret mode) and the port's plain scatter
of the same name: the matrix, the row minima and their first-index argmins
must be bit-identical. Then the whole ladder with kernel rounds
(`round_impl="pallas"`, whose wrapper `rnn_round_kernel` takes the plain
round `rnn_round` for a CPU tensor) is held against the JAX ladder with its
interpreted fused rounds, and against the port's own plain rounds
(`"xla"`). The level loop's host reads: a round on which no lane is active
changes nothing, so reading the host once every k rounds gives the merges
of a read before every round. On the card the kernel is held bit for bit
against the plain round (tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharp_tpu.ops import distance as jdist
from sharp_tpu.ops import linkage as jlink
from sharp_tpu.ops.linkage_pallas import rnn_round_scatter as j_round_scatter
from sharp_tpu_torch.ops import linkage as tlink
from sharp_tpu_torch.ops import linkage_cuda
from sharp_tpu_torch.ops.linkage_cuda import LAUNCHES
from torch_threads import one_torch_thread  # noqa: F401

STORES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
BIG = np.float32(jlink.BIG)


def _round_state(L, m, P, seed):
    """A round's inputs: W with coarse values (exact ties), BIG on the
    diagonal and on the rows and columns of clusters merged away earlier;
    fresh rows with ties and some BIG entries; per lane a number of pairs
    (lane 1 has none, as a frozen lane) whose survivors and dying clusters
    are disjoint, survivors in slot order by index."""
    rng = np.random.default_rng(seed)
    W = (rng.integers(1, 40, (L, m, m)) * 0.03125).astype(np.float32)
    rows = (rng.integers(1, 40, (L, P, m)) * 0.03125).astype(np.float32)
    rows[rng.random((L, P, m)) < 0.05] = BIG
    colslot = np.full((L, m), -1, np.int32)
    dying = np.zeros((L, m), bool)
    for lane in range(L):
        W[lane][np.arange(m), np.arange(m)] = BIG
        dead = rng.choice(m, 6, replace=False)
        W[lane][dead, :] = BIG
        W[lane][:, dead] = BIG
        n_pairs = (P if lane == 0 else 0) if L > 1 else P // 2
        if lane == 2:
            n_pairs = P // 3
        live = np.setdiff1d(np.arange(m), dead)
        pick = rng.choice(live, 2 * n_pairs, replace=False)
        a = np.sort(pick[:n_pairs])
        colslot[lane, a] = np.arange(n_pairs)
        dying[lane, pick[n_pairs:]] = True
    return W, rows, colslot, dying


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_round_scatter_matches_jax_interpret(store):
    tst, jst = STORES[store]
    L, m, P = 3, 256, 32
    W, rows, colslot, dying = _round_state(L, m, P, seed=1 if store == "f32" else 2)
    Wj = jnp.asarray(W).astype(jst)
    rowsj = jnp.asarray(rows).astype(jst)
    OHa = (colslot[:, None, :] == np.arange(P)[None, :, None]).astype(np.float32)
    ref = jax.vmap(lambda d, nr, oh, ca, dy: j_round_scatter(d, nr, oh, ca, dy, interpret=True))(
        Wj, rowsj, jnp.asarray(OHa).astype(jst),
        jnp.asarray((colslot >= 0).astype(np.float32)), jnp.asarray(dying.astype(np.float32)),
    )
    Wt = torch.from_numpy(W).to(tst)
    rowmin, rowarg = tlink.rnn_round_scatter(
        Wt, torch.from_numpy(rows).to(tst), torch.from_numpy(colslot), torch.from_numpy(dying)
    )
    assert rowmin.dtype == torch.float32 and rowarg.dtype == torch.int64
    np.testing.assert_array_equal(Wt.float().numpy(), np.asarray(ref[0].astype(jnp.float32)))
    np.testing.assert_array_equal(rowmin.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(rowarg.numpy(), np.asarray(ref[2]))
    # dying rows are all BIG: their argmin is the first index
    assert (rowarg.numpy()[dying] == 0).all()


def _distance(n, nreal, p, seed, dup=0, types=0):
    rng = np.random.default_rng(seed)
    X = np.zeros((n, p), np.float32)
    if types:
        cents = rng.normal(size=(types, p)) * 3.0
        X[:nreal] = cents[rng.integers(0, types, nreal)] + rng.normal(size=(nreal, p))
    else:
        X[:nreal] = rng.normal(size=(nreal, p))
    X[1 : 1 + dup] = X[0]
    m = jnp.asarray(np.arange(n) < nreal)
    return np.array(jdist.pearson_distance(jdist.standardize_rows(jnp.asarray(X), m), m))


def _cuts(merges, nreal, n):
    mask = np.arange(n) < nreal
    return np.asarray(jlink.cutree_multi(
        jnp.asarray(np.asarray(merges)), jnp.asarray(nreal), jnp.asarray(mask), jnp.asarray(40),
        minN=2, ncand=39, nc_pad=48,
    ).labels)


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_ladder_kernel_rounds_match_jax_fused_rounds(store):
    """The inputs of tests/test_linkage.py::test_fused_round_bit_identical
    (n 512, 490 real points of 9 planted types), with the ladder down to 64
    so that three levels run fused rounds."""
    tst, jst = STORES[store]
    n, nreal = 512, 490
    D = _distance(n, nreal, 48, seed=7, types=9)
    ref = jlink.ward_linkage_rnn(
        jnp.asarray(D), store_dtype=jst, compact_n=64, round_impl="pallas_interpret",
        tail="pallas_interpret",
    )
    got = tlink.ward_linkage_rnn(torch.from_numpy(D), store_dtype=tst, compact_n=64, round_impl="pallas")
    k = nreal - 1
    np.testing.assert_array_equal(got.merges.numpy()[:k], np.asarray(ref.merges)[:k])
    np.testing.assert_allclose(got.heights.numpy()[:k], np.asarray(ref.heights)[:k], rtol=1e-6)
    np.testing.assert_array_equal(_cuts(got.merges.numpy(), nreal, n), _cuts(ref.merges, nreal, n))
    assert tlink.validate_merge_sequence(got.merges, got.heights, nreal, n) == []


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_kernel_rounds_equal_plain_rounds(store):
    """round_impl "pallas" (and "auto") against "xla", bit for bit; lanes
    of one batched call (different real counts, so frozen lanes) against
    single calls; level sizes that are not powers of two (768, 384)."""
    tst, _ = STORES[store]
    D = np.stack([_distance(768, nr, 20, seed=nr, dup=2) for nr in (768, 420, 90)])
    Dt = torch.from_numpy(D)
    kw = dict(store_dtype=tst, compact_n=96)
    plain = tlink.ward_linkage_rnn(Dt, round_impl="xla", **kw)
    fused = tlink.ward_linkage_rnn(Dt, round_impl="pallas", **kw)
    assert torch.equal(fused.merges, plain.merges)
    assert torch.equal(fused.heights, plain.heights)
    assert tlink._round_fused("auto") and not tlink._round_fused("xla")
    for lane in (1, 2):
        one = tlink.ward_linkage_rnn(Dt[lane], round_impl="pallas", **kw)
        assert torch.equal(one.merges, plain.merges[lane])
        assert torch.equal(one.heights, plain.heights[lane])
    with pytest.raises(ValueError, match="round_impl"):
        tlink.ward_linkage_rnn(Dt, round_impl="pallas_bf16")


def test_row_cache_is_carried_between_fused_rounds(monkeypatch):
    """A kernel round leaves the next round's cache (the rows' minima of
    the scattered matrix); the first round of each level and the plain
    rounds compute it from the matrix."""
    D = torch.from_numpy(_distance(512, 500, 16, seed=3)[None])
    seen = []
    real_kernel = linkage_cuda.rnn_round_kernel

    def spy(ladder, nxt, P):
        seen.append((ladder.D.shape[-1], ladder.rowcache is not None))
        if ladder.rowcache is not None:
            vmin, arg = ladder.D.min(dim=2)
            assert torch.equal(ladder.rowcache[0], vmin.float()) and torch.equal(ladder.rowcache[1], arg)
        return real_kernel(ladder, nxt, P)

    monkeypatch.setattr(linkage_cuda, "rnn_round_kernel", spy)
    tlink.rnn_ladder(D, compact_n=128, round_impl="pallas")
    firsts = [i for i, (m, _) in enumerate(seen) if i == 0 or seen[i - 1][0] != m]
    assert [seen[i][1] for i in firsts] == [False] * len(firsts)
    assert any(c for _, c in seen)
    seen.clear()
    real_round = tlink.RnnLadder.round

    def spy_round(self, active, P):
        seen.append((self.D.shape[-1], self.rowcache is not None))
        return real_round(self, active, P)

    monkeypatch.setattr(tlink.RnnLadder, "round", spy_round)
    tlink.rnn_ladder(D, compact_n=128, round_impl="xla")
    assert seen and not any(c for _, c in seen)


# --- the level loop's host reads ---------------------------------------------

FIELDS = ("D", "alive", "sizes", "gidx", "lasth", "merges", "heights", "cnt", "rounds")


def _pad_heavy(n=256, reals=(256, 120, 40)):
    """L = 3 lanes at n_pad n: a full lane, a half-full one and a pad-heavy
    one (about 40 real of 256), whose pads merge one pair a round."""
    return torch.from_numpy(np.stack([_distance(n, nr, 16, seed=nr) for nr in reals]))


def _state(ladder):
    return {k: getattr(ladder, k).clone() for k in FIELDS}


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_noop_round_changes_nothing(store):
    """A round on which no lane is active (every lane at or below nxt
    clusters) leaves every field of the ladder bit-identical: no pairs,
    nothing scattered, `rounds` unmoved; `_append` writes only the discard
    slot n - 1, with the (0, 0, BIG) an earlier round with an empty pair
    slot left there. The same through the plain round, `rnn_round` and the
    round kernel's wrapper, which counts no launch on a CPU tensor."""
    tst, _ = STORES[store]
    n, P = 256, 64
    s = tlink.RnnLadder(_pad_heavy(n), tst)
    # on a fresh ladder the no-op round writes only the discard slot
    before = _state(s)
    s.round(s.active(n), P)
    after = _state(s)
    for k in FIELDS:
        if k in ("merges", "heights"):
            assert torch.equal(after[k][:, : n - 1], before[k][:, : n - 1])
        else:
            assert torch.equal(after[k], before[k]), k
    assert (after["merges"][:, n - 1] == 0).all() and (after["heights"][:, n - 1] == np.float32(1e30)).all()
    # a few real rounds toward n // 2 (every lane has fewer than P pairs in one)
    for _ in range(3):
        tlink.rnn_round(s, n // 2, P)
    assert (s.rounds == 3).all() and (s.cnt > 0).all()
    launches = LAUNCHES["rnn_round"]
    for step in (lambda: s.round(s.active(n), P), lambda: tlink.rnn_round(s, n, P),
                 lambda: linkage_cuda.rnn_round_kernel(s, n, P)):
        before = _state(s)
        cache = tuple(x.clone() for x in s.row_cache())
        step()
        for k, x in _state(s).items():
            assert torch.equal(x, before[k]), k
        assert all(torch.equal(a, b) for a, b in zip(s.row_cache(), cache))
    assert LAUNCHES["rnn_round"] == launches


@pytest.mark.parametrize("round_impl", ["pallas", "xla"])
@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_level_loop_reads_every_k_rounds(monkeypatch, store, round_impl):
    """The level loop reading the host once every 8 rounds (the card's
    default for kernel rounds) gives the merges, heights and rounds per
    lane of a read before every round, on three lanes with a pad-heavy one
    (one-pair rounds); it reads once at a level's start and once after
    every 8 rounds."""
    tst, _ = STORES[store]
    D = _pad_heavy()
    runs = {}
    k8 = tlink.LADDER_READ_EVERY
    real_compact = tlink.RnnLadder.compact
    for k in (1, k8):
        levels = []

        def spy(self, Cn, levels=levels):
            levels.append((self.D.shape[-1], self.rounds.clone(), self.cnt.clone()))
            return real_compact(self, Cn)

        monkeypatch.setattr(tlink.RnnLadder, "compact", spy)
        monkeypatch.setattr(tlink, "_read_every", lambda D, fused, k=k: k)
        s = tlink.rnn_ladder(D, store_dtype=tst, compact_n=64, round_impl=round_impl)
        runs[k] = (s, levels, s.finish(*tlink.rnn_tail(*s.tail_inputs())))
    (s1, lv1, link1), (s8, lv8, link8) = runs[1], runs[k8]
    assert torch.equal(link1.merges, link8.merges) and torch.equal(link1.heights, link8.heights)
    for k in FIELDS:
        assert torch.equal(getattr(s1, k), getattr(s8, k)), k
    assert [m for m, _, _ in lv1] == [m for m, _, _ in lv8] == [256, 128]
    for (_, r1, c1), (_, r8, c8) in zip(lv1, lv8):
        assert torch.equal(r1, r8) and torch.equal(c1, c8)
    # rounds per level: the most any lane took; the pad-heavy lane takes
    # one-pair rounds, more than the full lane
    per_level = [int(r.max()) for _, r, _ in lv1]
    assert lv1[0][1][2] > lv1[0][1][0]
    assert s1.host_reads == sum(1 + r for r in per_level)
    assert s8.host_reads == sum(1 + math.ceil(r / k8) for r in per_level)
    assert k8 == 8 and s8.host_reads < s1.host_reads


@pytest.mark.parametrize("round_impl", ["pallas", "xla"])
def test_plain_rounds_read_every_round(monkeypatch, round_impl):
    """Plain rounds (a CPU ladder, either round_impl) read the host before
    every round: a plain round does its whole work even with no lane
    active, so no round runs after every lane is done; the merges are those
    of a read every 8 rounds, the card kernel's interval."""
    D = _pad_heavy()
    calls = []
    real_round = tlink.RnnLadder.round

    def spy(self, active, P):
        calls.append(bool(active.any()))
        return real_round(self, active, P)

    monkeypatch.setattr(tlink.RnnLadder, "round", spy)
    s = tlink.rnn_ladder(D, compact_n=64, round_impl=round_impl)
    assert calls and all(calls)
    assert s.host_reads == sum(1 + int(r) for r in s.level_rounds)
    assert tlink._read_every(D, True) == 1 and tlink._read_every(D, False) == 1
    monkeypatch.setattr(tlink, "_read_every", lambda D, fused: tlink.LADDER_READ_EVERY)
    k8 = tlink.rnn_ladder(D, compact_n=64, round_impl=round_impl)
    assert not all(calls) and k8.host_reads < s.host_reads
    assert torch.equal(k8.merges, s.merges) and torch.equal(k8.heights, s.heights)
