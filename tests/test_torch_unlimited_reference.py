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
pass and one wait a fold group.
"""

import numpy as np
import pytest
import torch

import sharp_tpu_torch
from perfbench.data.atlas import ternary_rp
from perfbench.data.csr_atlas import CsrAtlas
from perfbench.reference import cluster
from perfbench.reference import unlimited as ref_unlimited
from perfbench.reference.compare import label_gap, rel_err
from sharp_tpu_torch.io import sparse
from sharp_tpu_torch.ops.rp import ensemble_rp_matrix
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
    ref = reference
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
