"""The port's large tier held to the benchmark's plain reference of it
(`perfbench/reference/large.py`) on the CPU: `sharp()` at a size that
forces the large tier (1,200 cells, folds of 200 at n_pad 256, K=3, p=32,
float32, forview on), with the RP matrices and the cell permutation
handed in from a seed. Final labels, folds and each member's k exact; the
ensemble-mean projection (`viE`) and the members' max silhouettes within
1e-5. The fold groups (one of 6 folds, or 4 + 2 under a memory budget)
do not change the answer, nor do two data shards of a CPU mesh. Also: the comparison fails for a shifted
permutation; a traced call counts the dense feed's bytes; the dense feed's
groups equal a plain gather into zeroed arrays bit for bit, through a fixed
set of reused host slots and at most two group buffers at once; a shuffle
that is not a permutation is refused.
"""

import sys
import weakref

import numpy as np
import pytest
import torch

import sharp_tpu_torch
from perfbench.reference import cluster
from perfbench.reference import large as ref_large
from perfbench.reference.compare import label_gap, rel_err
from sharp_tpu_torch.config import resolve_config
from sharp_tpu_torch.parallel import sharded
from sharp_tpu_torch.utils import timers
from tests.synth import make_tpm_like
from torch_threads import one_torch_thread  # noqa: F401

N, GENES, K, P, FOLD, PAD = 1200, 300, 3, 32, 200, 256
KNOBS = dict(base_ncells=500, partition_ncells=FOLD, ensize_K=K, reduced_ndim=P, prep=False,
             log_transform=True, rN_seed=11, device="cpu")
STAGES = ["preprocess", "log_decision", "permute_partition", "rp_setup", "fold_ensemble", "smetac", "finalize"]


@pytest.fixture(scope="module")
def inputs():
    X, _ = make_tpm_like(n_cells=N, n_genes=GENES, n_types=5, seed=23)
    rng = np.random.default_rng(5)
    s = np.sqrt(GENES)
    u = rng.random((GENES, K * P))
    R = np.where(u < 0.5 / s, np.sqrt(s), np.where(u > 1 - 0.5 / s, -np.sqrt(s), 0.0)).astype(np.float32)
    return X.astype(np.float32), torch.from_numpy(R), rng.permutation(N)


def _budget_for(group):
    """A memory budget under which `auto_group` picks `group` folds."""
    cfg = resolve_config(N, GENES, **{k: v for k, v in KNOBS.items() if k != "device"})
    fold = sharded._fold_bytes(PAD, GENES, False, K, **sharded._sweep_shape(cfg))
    return sharded.SWEEP_CHUNK_BYTES + group * fold + fold // 2


def _reference(X, R, perm, prefer=None):
    with cluster.full_float32():
        return ref_large.sharp_large(X, R, perm, ref_large.config(N, K, p=P, partition_ncells=FOLD),
                                     torch.device("cpu"), prefer=prefer)


@pytest.fixture(scope="module", params=[("one_group", None, 1), ("two_groups", 4, 1), ("two_shards", None, 2)],
                ids=lambda p: p[0])
def case(request, inputs):
    """The port's answer with the groups (or the mesh's data shards) asked
    for, the fold groups' lanes, and the reference's answer."""
    X, R, perm = inputs
    mp = pytest.MonkeyPatch()
    lanes = []
    inner = sharded.fold_program

    def counted(Xg, *a, **k):
        lanes.append(Xg.shape[0])
        return inner(Xg, *a, **k)

    try:
        mp.setattr(sharded, "fold_program", counted)
        _, group, shards = request.param
        if group is not None:
            mp.setenv("SHARP_TPU_HBM_BUDGET", str(_budget_for(group)))
        timers.reset()
        got = sharp_tpu_torch.sharp(X, rM=R, shuffle_perm=torch.from_numpy(perm), n_devices=shards, **KNOBS)
        counted_untraced = sorted(k for k in timers.snapshot()["sums"] if k.startswith("feed."))
        mp.undo()
        ref = _reference(X, R, perm, prefer={"k_per": got.per_member_k, "labels": got.pred_clusters})
    finally:
        mp.undo()
    return dict(got=got, ref=ref, lanes=lanes, counted_untraced=counted_untraced)


@pytest.fixture(scope="module")
def shifted(inputs):
    """The reference on the permutation shifted by one cell."""
    X, R, perm = inputs
    return _reference(X, R, np.roll(perm, 1))


def test_large_tier_matches_plain_reference(case):
    got, ref = case["got"], case["ref"]
    assert sorted(case["lanes"]) in ([6], [2, 4], [3, 3])
    np.testing.assert_array_equal(got.pred_clusters, ref.labels)
    np.testing.assert_array_equal(got.folds, ref.folds)
    np.testing.assert_array_equal(got.per_member_k, ref.k_per)
    assert rel_err(got.viE, ref.viE) <= 1e-5
    assert np.abs(got.per_member_maxsil - ref.maxsil).max() <= 1e-5
    assert got.N_pred_cluster >= 2
    # untraced, the feed keeps its host seconds and the tracer counts nothing
    assert got.timing["fold_pass"]["slice_s"] > 0.0 and case["counted_untraced"] == []


def test_shifted_perm_fails_the_comparison(case, shifted):
    """The reference on the permutation shifted by one cell: the folds and
    the projection no longer match the port's."""
    got, ref = case["got"], shifted
    assert (got.folds != ref.folds).sum() > 0
    assert rel_err(got.viE, ref.viE) > 1e-5 or label_gap(got.pred_clusters, ref.labels) > 0


def test_traced_call_counts_the_dense_feed(inputs):
    """Under a profiler the feed counts the live rows gathered, the bytes
    copied (pad rows in) and, of those, the ones from page-locked and from
    pageable slots: on the CPU no slot is page-locked. The result carries
    the feed's host seconds beside unchanged stages."""
    X, R, _ = inputs
    n = 2 * FOLD                        # two folds keep the profiled call short
    knobs = {**KNOBS, "base_ncells": n}
    timers.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        res = sharp_tpu_torch.sharp(X[:n], rM=R, shuffle_perm=torch.randperm(n), **knobs)
    sums = timers.snapshot()["sums"]
    timers.reset()
    folds = n // FOLD
    assert sums["feed.gathered_bytes"] == n * GENES * 4
    assert sums["feed.copied_bytes"] == folds * PAD * GENES * 4
    assert sums["feed.pinned_bytes"] == 0
    assert sums["feed.pageable_bytes"] == sums["feed.copied_bytes"]
    assert [s["stage"] for s in res.timing["stages"]] == STAGES
    assert set(res.timing["fold_pass"]) == {"slice_s", "transfer_s"}
    assert all(v >= 0.0 for v in res.timing["fold_pass"].values())
    fold_stage = next(s["seconds"] for s in res.timing["stages"] if s["stage"] == "fold_ensemble")
    assert sum(res.timing["fold_pass"].values()) <= fold_stage


@pytest.mark.parametrize("bad", ["repeated", "out_of_range", "negative"])
def test_shuffle_perm_must_be_a_permutation(inputs, bad):
    X, R, perm = inputs
    perm = perm.copy()
    perm[0] = {"repeated": perm[1], "out_of_range": N, "negative": -1}[bad]
    with pytest.raises(ValueError, match="not a permutation"):
        sharp_tpu_torch.sharp(X, rM=R, shuffle_perm=torch.from_numpy(perm), **KNOBS)


# unequal folds, the last one short: 19 folds, so groups of 2 and 16 end short
FEED_SIZES = [12, 15, 13, 16, 14] * 3 + [16, 11, 14, 5]
FEED_PAD, FEED_GENES = 16, 37


def _feed_matrix(n, seed):
    """Float32 cells with NaNs and negative zeros, so that equal bytes is
    more than equal values."""
    X = np.random.default_rng(seed).standard_normal((n, FEED_GENES)).astype(np.float32)
    X[::7, 3] = np.nan
    X[::5, 4] = -0.0
    return X


def _plain_groups(X, sizes, group, rows):
    """Each group gathered with numpy into a zeroed (G, pad, genes) array."""
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    out = []
    for g0 in range(0, len(sizes), group):
        Xg = np.zeros((len(sizes[g0 : g0 + group]), FEED_PAD, X.shape[1]), np.float32)
        for j, sz in enumerate(sizes[g0 : g0 + group]):
            Xg[j, :sz] = X[rows[offsets[g0 + j] : offsets[g0 + j] + sz]]
        out.append(Xg)
    return out


def _fed_groups(X, sizes, group, rows):
    """The dense feed's groups, copied out as `_fold_groups` would use them,
    with a short thread switch interval."""
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        feed = sharded._dense_feed(X, sizes, offsets, group, FEED_PAD, rows, True, torch.device("cpu"), None)
        return [(gsizes, data.numpy().copy()) for gsizes, data, _ in feed]
    finally:
        sys.setswitchinterval(old)


def _assert_same_bytes(got, want):
    assert [g.shape for _, g in got] == [w.shape for w in want]
    for (_, g), w in zip(got, want):
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("order", ["own", "permuted"])
@pytest.mark.parametrize("group", [1, 2, 16])
def test_dense_feed_equals_plain_gather(group, order):
    """The pipelined feed's groups are a plain gather into zeroed arrays,
    byte for byte and pad rows included: unequal folds with a short last
    one, in the block's own order or permuted, in groups of 1, 2 and 16
    (the last group short)."""
    n = sum(FEED_SIZES)
    X = _feed_matrix(n, 3)
    rows = np.arange(n) if order == "own" else np.random.default_rng(4).permutation(n)
    got = _fed_groups(X, FEED_SIZES, group, rows)
    _assert_same_bytes(got, _plain_groups(X, FEED_SIZES, group, rows))
    assert [g for g, _ in got] == [FEED_SIZES[g0 : g0 + group] for g0 in range(0, len(FEED_SIZES), group)]


@pytest.mark.parametrize("group", [1, 3])
def test_dense_feed_reuses_its_slots_without_stale_rows(monkeypatch, group):
    """Two calls on different matrices go through the same slot set; the
    second call's shorter folds leave no row of the first in the pad."""
    monkeypatch.setattr(sharded, "_FREE_SLOTS", {})
    key = (FEED_PAD, FEED_GENES, torch.device("cpu"))
    X1 = _feed_matrix(6 * FEED_PAD, 5)
    full, own = [FEED_PAD] * 6, np.arange(len(X1))
    _assert_same_bytes(_fed_groups(X1, full, group, own), _plain_groups(X1, full, group, own))
    [slots] = sharded._FREE_SLOTS[key]
    short = [9, 5, 12, 3, 7, 1]
    X2 = _feed_matrix(sum(short), 6)
    rows = np.random.default_rng(7).permutation(len(X2))
    _assert_same_bytes(_fed_groups(X2, short, group, rows), _plain_groups(X2, short, group, rows))
    assert sharded._FREE_SLOTS[key] == [slots]


@pytest.mark.parametrize("n_groups", [1, 4, 12])
def test_dense_feed_staging_stays_bounded(monkeypatch, n_groups):
    """Whatever the number of groups, the feed stages through one fixed
    set of host slots, made once and reused by the next call, and no more
    than two group buffers are alive at once: the one the caller holds and
    the one the worker fills."""
    monkeypatch.setattr(sharded, "_FREE_SLOTS", {})
    made, buffers, alive_at_alloc = [], [], []

    class Counted(sharded._Slots):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(len(self.bufs))

    inner = sharded._group_buffer

    def tracked(*a, **k):
        data = inner(*a, **k)
        buffers.append(weakref.ref(data))
        alive_at_alloc.append(sum(b() is not None for b in buffers))
        return data

    monkeypatch.setattr(sharded, "_Slots", Counted)
    monkeypatch.setattr(sharded, "_group_buffer", tracked)
    sizes = [FEED_PAD - 1] * (2 * n_groups)
    X = _feed_matrix(sum(sizes), 8)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    for _ in range(2):
        for gsizes, data, _ in sharded._dense_feed(X, sizes, offsets, 2, FEED_PAD, np.arange(len(X)), True,
                                                   torch.device("cpu"), None):
            assert sum(b() is not None for b in buffers) <= 2
            del data
    assert made == [sharded._MAX_SLOTS]
    assert len(buffers) == 2 * n_groups and max(alive_at_alloc) <= 2
    assert all(b() is None for b in buffers)
