"""The port's small tier on UMI counts held to the benchmark's plain
reference of it (`perfbench/reference/small.py`) on the CPU: `sharp()` at
its defaults on a 10x-like count matrix (`perfbench/data/umi.py`: 230
cells at n_pad 256, 300 genes of which about half are zero in every
cell), with `exp_type="count"` (prep's clamp and all-zero-gene drop, then
CPM) and the testlog decision, K=3, p=32, the RP matrices and the
testlog's draws handed in from a seed. Both linkage routes: "auto" (serial
Ward at this size) and "rnn", the ladder the small tier takes above n_pad
1024, here with its levels compacted at 64 so that its rounds run before
the tail. Final labels and each member's k exact; the ensemble-mean
projection (`viE`) and the members' max silhouettes within 1e-5. Also: the
comparison fails for a reference that skips CPM; a traced call counts the
genes the prep drops and the host bytes of its passes under the spans
`sharp.preprocess.{prep,normalize}`, and the ladder's merged pairs within
its pair slots.

Pinned: a sample with hardly any recoverable types (markers few and weak),
on which the comparison fails though the port is faithful. The port's
float32 distances and the reference's part by rounding alone (4.8e-7 at
most), the near-tied Ward heights of such a sample then order an early
merge differently, and a member's max silhouette parts by 2.8e-5, above
the cell's 1e-5. Given the port's own distances, the reference's greedy
Ward gives the port's tree and the reference the port's whole answer.
"""

import functools

import numpy as np
import pytest
import torch

import sharp_tpu_torch
from perfbench.data import umi
from perfbench.data.atlas import ternary_rp
from perfbench.reference import cluster, small
from perfbench.reference.compare import rel_err
from sharp_tpu_torch.core import block, pipeline
from sharp_tpu_torch.ops import linkage, select
from sharp_tpu_torch.utils import timers
from torch_threads import one_torch_thread  # noqa: F401

N, GENES, K, P = 230, 300, 3, 32
SHARES = [0.30, 0.21, 0.14, 0.12, 0.09, 0.07, 0.04, 0.022, 0.008]
SAMPLE = dict(median_umis=3500, umi_sigma=0.45, gene_sigma=2.5, never_detected=0.5, marker_pool=60, markers=6,
              marker_lfc=(2.0, 5.0))
CPU = torch.device("cpu")
# few weak markers: next to no recoverable types
WEAK = {**SAMPLE, "marker_pool": 140, "markers": 3, "marker_lfc": (1.5, 4.0)}


@pytest.fixture(scope="module")
def inputs():
    """The raw counts, the genes with a count, the RP matrices and the
    testlog's draws for the genes prep keeps."""
    sample = umi.make(N, GENES, SHARES, 2**31 + 4340, CPU, **SAMPLE)
    genes = int(sample.detected.sum())
    R = ternary_rp(genes, K * P, 17, CPU)
    probe = pipeline.TestlogProbe(torch.randperm(N, generator=torch.Generator().manual_seed(5)),
                                  ternary_rp(genes, P, 19, CPU))
    return sample, R, probe


def _reference(inputs, exp_type="count", prefer=None):
    sample, R, probe = inputs
    with cluster.full_float32():
        return small.sharp_small(torch.from_numpy(sample.X), R, probe.perm, probe.R, K, P, exp_type,
                                 prefer=prefer)


@pytest.fixture(scope="module", params=["auto", "rnn"])
def case(request, inputs):
    """The port's answer on the route asked for, traced, with the tracer's
    snapshot, and the reference's answer."""
    sample, R, probe = inputs
    mp = pytest.MonkeyPatch()
    try:
        # the ladder's levels compacted at 64 (its default 256 is the whole
        # problem here), so that the rounds run
        mp.setattr(select, "ward_linkage_rnn", functools.partial(linkage.ward_linkage_rnn, compact_n=64))
        timers.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            got = sharp_tpu_torch.sharp(sample.X, rM=R, testlog_probe=probe, device="cpu", ensize_K=K,
                                        reduced_ndim=P, exp_type="count", linkage_backend=request.param,
                                        rN_seed=7)
        snap = timers.snapshot()
        timers.reset()
    finally:
        mp.undo()
    ref = _reference(inputs, prefer={"k_per": got.per_member_k, "labels": got.pred_clusters})
    return dict(route=request.param, got=got, ref=ref, snap=snap)


def test_small_tier_on_counts_matches_plain_reference(case):
    got, ref = case["got"], case["ref"]
    assert got.paras["prep"] and got.paras["exp_type"] == "count"
    np.testing.assert_array_equal(got.pred_clusters, ref.labels)
    np.testing.assert_array_equal(got.per_member_k, ref.k_per)
    assert rel_err(got.viE, ref.viE) <= 1e-5
    assert np.abs(got.per_member_maxsil - ref.maxsil).max() <= 1e-5
    assert got.N_pred_cluster >= 2 and got.viE.shape == (N, P)


def test_reference_without_cpm_fails_the_comparison(case, inputs):
    """The reference with the count path's CPM left out: the projection,
    and with it the answer, no longer match the port's."""
    got, ref = case["got"], _reference(inputs, exp_type=None)
    assert rel_err(got.viE, ref.viE) > 1e-5
    assert rel_err(got.viE, ref.viE) > 1e3 * rel_err(got.viE, case["ref"].viE)


def test_traced_call_counts_the_preprocess_and_the_ladder(case, inputs):
    sample = inputs[0]
    snap = case["snap"]
    sums = snap["sums"]
    zero_genes = int((sample.X.sum(axis=0) == 0).sum())
    assert 0 < zero_genes < GENES
    assert sums["preprocess.genes_dropped"] == zero_genes == GENES - case["ref"].genes
    kept = (GENES - zero_genes) * N * 4
    # prep: clamp (read, write), gene sums, the drop (read, write the kept);
    # CPM: cell sums, divide and scale (read, write each)
    assert sums["preprocess.host_bytes"] == 4 * sample.X.nbytes + kept + 5 * kept
    assert snap["spans"]["preprocess.prep"] == snap["spans"]["preprocess.normalize"] == 1
    if case["route"] == "rnn":
        assert 0 < sums["ladder.pairs"] <= sums["ladder.pair_slots"]
        assert sums["ladder.pair_slots"] % 64 == 0      # P 128, then 64
    else:
        assert "ladder.pairs" not in sums and "ladder.pair_slots" not in sums


@pytest.fixture(scope="module", params=["auto", "rnn"])
def weak(request):
    """The port's answer on a weak sample, its members' distances and
    trees (captured at the linkage), and the sample's inputs."""
    sample = umi.make(N, GENES, SHARES, 3, CPU, **WEAK)
    genes = int(sample.detected.sum())
    R = ternary_rp(genes, K * P, 20, CPU)
    probe = pipeline.TestlogProbe(torch.randperm(N, generator=torch.Generator().manual_seed(3)),
                                  ternary_rp(genes, P, 22, CPU))
    cap = {}
    link = block.linkage

    def capture(D, backend, hmethod):
        out = link(D, backend, hmethod)
        if D.shape[-1] >= N:                  # the members, not the testlog's probe
            cap.update(D=D[:, :N, :N].clone(), merges=out.merges[:, : N - 1].long())
        return out

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(select, "ward_linkage_rnn", functools.partial(linkage.ward_linkage_rnn, compact_n=64))
        mp.setattr(block, "linkage", capture)
        got = sharp_tpu_torch.sharp(sample.X, rM=R, testlog_probe=probe, device="cpu", ensize_K=K, reduced_ndim=P,
                                    exp_type="count", linkage_backend=request.param, rN_seed=7)
    finally:
        mp.undo()
    return dict(got=got, inputs=(sample, R, probe), **cap)


def test_weak_sample_parts_from_the_reference_by_the_distances_rounding_alone(weak):
    got, prefer = weak["got"], {"k_per": weak["got"].per_member_k, "labels": weak["got"].pred_clusters}
    own = _reference(weak["inputs"], prefer=prefer)
    np.testing.assert_array_equal(got.pred_clusters, own.labels)
    np.testing.assert_array_equal(got.per_member_k, own.k_per)
    # the cell's exact comparison fails here: a member's max silhouette
    assert np.abs(got.per_member_maxsil - own.maxsil).max() > 1e-5
    sample, R, _ = weak["inputs"]
    with cluster.full_float32():
        X = small.preprocess(torch.from_numpy(sample.X), "count")
        D_ref = cluster.pearson_distance(cluster.project(X, R.float(), K, own.log, "float32"))
        greedy, _ = cluster.ward(weak["D"])
    gap = float((weak["D"] - D_ref).abs().max())
    assert 0 < gap <= 1e-6
    # the reference's Ward on the port's distances: the port's tree
    assert torch.equal(greedy, weak["merges"])
    mp = pytest.MonkeyPatch()
    try:
        plain = small.pearson_distance
        mp.setattr(small, "pearson_distance",
                   lambda F, kind="float32": weak["D"] if F.shape[-2] == N else plain(F, kind))
        on_port = _reference(weak["inputs"], prefer=prefer)
    finally:
        mp.undo()
    np.testing.assert_array_equal(got.pred_clusters, on_port.labels)
    np.testing.assert_array_equal(got.per_member_k, on_port.k_per)
    assert np.abs(got.per_member_maxsil - on_port.maxsil).max() <= 1e-6
