"""The port's large tier held to the benchmark's plain reference of it
(`perfbench/reference/large.py`) on the CPU: `sharp()` at a size that
forces the large tier (1,200 cells, folds of 200 at n_pad 256, K=3, p=32,
float32, forview on), with the RP matrices and the cell permutation
handed in from a seed. Final labels, folds and each member's k exact; the
ensemble-mean projection (`viE`) and the members' max silhouettes within
1e-5. The fold groups (one of 6 folds, or 4 + 2 under a memory budget)
do not change the answer, nor do two data shards of a CPU mesh. Also: the comparison fails for a shifted
permutation; a traced call counts the dense feed's bytes; the feed drops
each group's host buffer before the next gather; a shuffle that is not a
permutation is refused.
"""

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

N, GENES, K, P, FOLD, PAD = 1200, 300, 3, 32, 200, 256
KNOBS = dict(base_ncells=500, partition_ncells=FOLD, ensize_K=K, reduced_ndim=P, prep=False,
             log_transform=True, rN_seed=11, device="cpu")
STAGES = ["preprocess", "log_decision", "permute_partition", "rp_setup", "fold_ensemble", "smetac", "finalize"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    copied (pad rows in) and, of those, the pageable ones; the result
    carries the feed's host seconds beside unchanged stages."""
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


def test_dense_feed_drops_each_group_before_the_next_gather(monkeypatch):
    """The feed keeps no reference to a group's host buffer into the next
    group's gather (two full groups' buffers would be resident at once)."""
    X = np.arange(12 * 5, dtype=np.float32).reshape(12, 5)
    sizes, offsets = [4, 4, 4], np.array([0, 4, 8, 12])
    feed = sharded._dense_feed(X, sizes, offsets, 1, 8, np.arange(12), True, torch.device("cpu"), None)
    gsizes, data, _ = next(feed)
    first = weakref.ref(data)
    del data
    alive = []
    inner = np.take

    def take(*a, **k):
        alive.append(first() is not None)
        return inner(*a, **k)

    monkeypatch.setattr(sharded.np, "take", take)
    gsizes, data, _ = next(feed)
    assert alive == [False] and gsizes == [4]
    np.testing.assert_array_equal(data[0, :4].numpy(), X[4:8])
