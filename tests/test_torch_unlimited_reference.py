"""The port's `sharp_unlimited` held to the benchmark's plain reference of
SHARP_unlimited (`perfbench/reference/unlimited.py`) on the CPU: three
CSR blocks of 600, 600 and 700 cells x 300 genes, 40 nonzeros a cell
(`perfbench/data/csr_atlas.py`), through the sparse feed with folds of 200
(ten folds at n_pad 256), K=3, p=32, float32, the RP matrices handed in
through `rM` from a seed. Final labels, folds, each member's k, the fold
consensus and the block labels exact; the members' max silhouettes and the
fold summaries within 1e-5; the same for any fold group and any batch of
block fuses. Also: the comparison fails for the blocks in a shifted order;
`rM` drawn as the call would draw it gives its answer bit for bit; a
traced call counts the sparse feed's nonzeros and wire bytes, one block
pass and one wait a fold group; the feed staging each block's first group
during the previous block's last gives each block's own answer bit for bit,
skips a resumed block, makes its wire sets once, and leaves no worker
behind an error.
"""

import glob
import os
import sys
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sharp_tpu_torch
from perfbench.data.atlas import ternary_rp
from perfbench.data.csr_atlas import CsrAtlas
from perfbench.reference import cluster
from perfbench.reference import unlimited as ref_unlimited
from perfbench.reference.compare import label_gap, rel_err
from sharp_tpu_torch.io import sparse
from sharp_tpu_torch.ops.rp import ensemble_rp_matrix
from sharp_tpu_torch.parallel import sharded, streaming
from sharp_tpu_torch.utils import timers
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SIZES, GENES, NNZ, K, P, FOLD, PAD = (600, 600, 700), 300, 40, 3, 32, 200, 256
KNOBS = dict(partition_ncells=FOLD, ensize_K=K, reduced_ndim=P, rN_seed=11, device="cpu")
# the folds: 3 of 200 in each 600-cell block; 200, 200, 150, 150 in the last
FOLDS = [200] * 8 + [150, 150]


@pytest.fixture(scope="module")
def inputs():
    data = CsrAtlas(GENES, 5, NNZ, 2**31 + 77, CPU)
    blocks = [data.block(b, n)[0] for b, n in enumerate(SIZES)]
    return blocks, ternary_rp(GENES, K * P, 991, CPU)


def _reference(blocks, R, got=None):
    prefer = None
    if got is not None:
        prefer = dict(k_per=got.per_member_k, fold_labels=got.fold_labels, block_labels=got.block_labels,
                      labels=got.pred_clusters)
    with cluster.full_float32():
        return ref_unlimited.sharp_unlimited(blocks, R, ref_unlimited.config(sum(SIZES), K, p=P, partition_ncells=FOLD),
                                             CPU, prefer=prefer)


@pytest.fixture(scope="module")
def answer(inputs):
    blocks, R = inputs
    return sharp_tpu_torch.sharp_unlimited(blocks, rM=R, **KNOBS)


@pytest.fixture(scope="module")
def reference(inputs, answer):
    return _reference(*inputs, got=answer)


@pytest.mark.parametrize("group,fuse_batch", [(None, 8), (1, 8), (2, 8), (None, 1)],
                         ids=["auto_batch8", "group1", "group2", "auto_batch1"])
def test_unlimited_matches_plain_reference(inputs, answer, reference, group, fuse_batch):
    blocks, R = inputs
    got = answer if (group, fuse_batch) == (None, 8) else sharp_tpu_torch.sharp_unlimited(
        blocks, rM=R, group=group, fuse_batch=fuse_batch, **KNOBS)
    _hold_to_reference(got, reference)


def _hold_to_reference(got, ref):
    np.testing.assert_array_equal(got.pred_clusters, ref.labels)
    np.testing.assert_array_equal(got.folds, ref.folds)
    np.testing.assert_array_equal(got.per_member_k, ref.k_per)
    np.testing.assert_array_equal(got.fold_labels, ref.fold_labels)
    np.testing.assert_array_equal(got.block_labels, ref.block_labels)
    np.testing.assert_array_equal(got.fold_counts, ref.counts)
    assert np.abs(got.per_member_maxsil - ref.maxsil).max() <= 1e-5
    assert rel_err(got.fold_cent_sum, ref.cent_sum) <= 1e-5
    assert np.bincount(got.folds).tolist() == FOLDS
    assert got.N_pred_cluster >= 2 and got.paras["reduced_ndim"] == P


def test_shifted_block_order_fails_the_comparison(inputs, answer):
    """The reference on the blocks shifted by one place: the fold partition
    and the summaries no longer match the port's."""
    blocks, R = inputs
    ref = _reference(blocks[-1:] + blocks[:-1], R)
    assert (answer.folds != ref.folds).sum() > 0
    assert (answer.fold_counts.shape != ref.counts.shape or (answer.fold_counts != ref.counts).any()
            or label_gap(answer.pred_clusters, ref.labels) > 0)


def test_rM_drawn_as_the_call_draws_it_gives_the_same_answer(inputs):
    blocks, _ = inputs
    R = ensemble_rp_matrix(KNOBS["rN_seed"], K, GENES, P, dtype=torch.float32, device=CPU)
    drawn = sharp_tpu_torch.sharp_unlimited(blocks, **KNOBS)
    handed = sharp_tpu_torch.sharp_unlimited(blocks, rM=[R[:, k * P : (k + 1) * P].numpy() for k in range(K)], **KNOBS)
    for f in ("pred_clusters", "folds", "per_member_k", "per_member_maxsil", "fold_labels", "block_labels",
              "fold_cent_sum", "fold_counts"):
        assert getattr(drawn, f).tobytes() == getattr(handed, f).tobytes(), f
    with pytest.raises(ValueError, match="rM has shape"):
        sharp_tpu_torch.sharp_unlimited(blocks, rM=R[:, :-1], **KNOBS)


def test_traced_call_counts_the_sparse_feed(inputs):
    """Under a profiler the sparse feed counts the blocks' nonzeros, the
    bytes of the triplet buffers it copied (none page-locked on the CPU)
    and of the dense folds it wrote; the block pass opens once and
    the caller's wait once a fold group (two groups of at most 2 folds a
    block)."""
    blocks, R = inputs
    timers.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        res = sharp_tpu_torch.sharp_unlimited(blocks, rM=R, group=2, **KNOBS)
    snap = timers.snapshot()
    timers.reset()
    sums, spans = snap["sums"], snap["spans"]
    budget = sparse.nnz_pad(FOLD * NNZ)
    counts, cols, vals = sparse.wire_buffers(1, PAD, budget, GENES)
    per_fold = counts.nbytes + cols.nbytes + vals.nbytes
    assert sums["feed.nnz"] == sum(b.nnz for b in blocks) == sum(SIZES) * NNZ
    assert sums["feed.wire_bytes"] == len(FOLDS) * per_fold
    assert sums["feed.wire_pinned_bytes"] == 0
    assert sums["feed.dense_bytes"] == len(FOLDS) * PAD * GENES * 4
    assert spans["unlimited.block_pass"] == 1
    assert spans["fold_pass.wait"] == 2 * len(SIZES)
    assert set(res.timing["fold_pass"]) == {"slice_s", "transfer_s", "wait_s"}
    assert res.timing["fold_pass"]["slice_s"] > 0.0 and res.timing["fold_pass"]["wait_s"] >= 0.0
    # untraced, nothing is counted
    sharp_tpu_torch.sharp_unlimited(blocks[:2], rM=R, **KNOBS)
    assert not any(k.startswith("feed.") for k in timers.snapshot()["sums"])


# what a call returns of its blocks' fold passes and fuses
FIELDS = ("pred_clusters", "block_labels", "folds", "fold_labels", "fold_cent_sum", "fold_counts", "per_member_k",
          "per_member_maxsil")


def _traced(fn):
    """fn() under a profiler -> (its result, the tracer's sums)."""
    timers.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            out = fn()
        return out, timers.snapshot()["sums"]
    finally:
        timers.reset()


@pytest.mark.parametrize("group", [1, 2, 3])
def test_feed_across_blocks_equals_each_block_alone(inputs, reference, monkeypatch, tmp_path, group):
    """The call's one sparse feed stages each block's first group while the
    previous block's last group runs (groups of 1, 2 and 3 folds split the
    blocks' 3, 3 and 4 folds unevenly), under a short thread switch
    interval: the summaries and labels are byte for byte those of each
    block's fold pass fed alone, and held to the plain reference. With the
    middle block resumed from its manifest, the worker skips it: the last
    block's first group is staged during the first block's last, and the
    labels are the whole call's."""
    blocks, R = inputs
    call = lambda **kw: sharp_tpu_torch.sharp_unlimited(blocks, rM=R, group=group, **kw, **KNOBS)  # noqa: E731
    real_pass = streaming._fold_pass

    def alone(*a, pipeline=None, **k):
        return real_pass(*a, **k)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        across, sums = _traced(lambda: call(manifest_dir=str(tmp_path)))
        for b in (0, 2):
            [path] = glob.glob(str(tmp_path / f"block_{b:05d}_*.npz"))
            os.remove(path)
        resumed, resumed_sums = _traced(lambda: call(manifest_dir=str(tmp_path)))
        with monkeypatch.context() as m:
            m.setattr(streaming, "_fold_pass", alone)
            each, each_sums = _traced(call)
    finally:
        sys.setswitchinterval(old)
    for f in FIELDS:
        assert getattr(across, f).tobytes() == getattr(each, f).tobytes(), f
    _hold_to_reference(across, reference)
    assert sums["feed.block_first_ahead"] == len(SIZES) - 1
    assert "feed.block_first_ahead" not in each_sums
    assert resumed_sums["feed.block_first_ahead"] == 1 and resumed.folds is None
    np.testing.assert_array_equal(resumed.pred_clusters, across.pred_clusters)
    np.testing.assert_array_equal(resumed.block_labels, across.block_labels)


def test_feed_makes_its_wire_sets_once(inputs, monkeypatch):
    """Two traced calls: each stages every block's first group but the
    call's first ahead; the first makes the two wire sets (each holds a
    block's whole group, so the short last groups fit), the second reuses
    them and makes none."""
    blocks, R = inputs
    monkeypatch.setattr(sharded, "_FREE_WIRE", {})
    counts = []
    for _ in range(2):
        _, sums = _traced(lambda: sharp_tpu_torch.sharp_unlimited(blocks, rM=R, group=2, **KNOBS))
        counts.append((sums["feed.block_first_ahead"], sums.get("feed.wire_sets_made", 0)))
    assert counts == [(len(SIZES) - 1, 2), (len(SIZES) - 1, 0)]


class _Unreadable(sp.csr_matrix):
    def tocsr(self, copy=False):
        raise OSError("block unreadable")


@pytest.mark.parametrize("fault", ["load", "fold_program"])
def test_feed_errors_raise_and_leave_no_worker(inputs, monkeypatch, fault):
    """A block whose load raises on the prefetch thread, and a fold program
    that raises in the first block's last group (the next block's first
    group staged meanwhile): the call raises that error, and no thread of
    the sparse feed is left."""
    blocks, R = inputs
    if fault == "load":
        blocks = [blocks[0], _Unreadable(blocks[1]), blocks[2]]
        err = OSError
    else:
        calls, real = [], sharded.fold_program

        def failing(*a, **k):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("fold program failed")
            return real(*a, **k)

        monkeypatch.setattr(sharded, "fold_program", failing)
        err = RuntimeError
    with pytest.raises(err):
        sharp_tpu_torch.sharp_unlimited(blocks, rM=R, group=2, **KNOBS)
    assert not [t for t in threading.enumerate() if t.name.startswith("sparse-feed")]
