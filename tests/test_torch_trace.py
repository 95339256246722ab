"""The port's tracer (`sharp_tpu_torch.utils.timers`) on the CPU.

Off (no profiler recording), no span site enters a `record_function`.
Under `torch.profiler` the program's `sharp.*` spans nest as its layers
do, and a span reached from two layers says which one it is in; the host
reads of a call are counted exactly, and not more with more lanes; the
ladder's live lane-rounds are the sum of its levels' `rounds`; the cut
replay's bytes at (80, 2048) are the kernel table's 8.0 us bound; the
round kernel's bytes, counted from the ladder's per-level sums, are never
above `chip_smoke.round_bytes` summed over the same rounds.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sharp_tpu_torch
from sharp_tpu_torch.config import resolve_config
from sharp_tpu_torch.core.fold import fold_program, fold_static_args
from sharp_tpu_torch.core.large import summaries_to_host
from sharp_tpu_torch.ops import linkage as tlink
from sharp_tpu_torch.ops import linkage_cuda
from sharp_tpu_torch.ops.linkage_cuda import cutree_bytes
from sharp_tpu_torch.ops.select import prep_distance
from sharp_tpu_torch.utils import timers
from synth import make_tpm_like
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ["preprocess", "stage_rp_setup", "log_decision", "ensemble_cluster", "wmetac", "finalize"]
SMALL_READS = {"pipeline.testlog_maxsil": 2, "pipeline.k_per": 1, "pipeline.finalC": 1,
               "pipeline.viE": 1, "pipeline.x0": 1, "pipeline.maxsil": 1}


@pytest.fixture(autouse=True)
def fresh_tracer():
    timers.reset()
    yield
    timers.reset()


def _small_call():
    X, _ = make_tpm_like(n_cells=150, n_genes=300, n_types=4, seed=3)
    return sharp_tpu_torch.sharp(X, rN_seed=3, ensize_K=4, reduced_ndim=16, device="cpu", exp_type="TPM")


def _fold_group(G, K=4, B=64, backend="auto"):
    """A CPU fold_program over G folds of K members and its host summaries."""
    genes = 200
    X, _ = make_tpm_like(n_cells=150, n_genes=genes, n_types=4, seed=3)
    cfg = resolve_config(150, genes, rN_seed=1, ensize_K=K, reduced_ndim=8, linkage_backend=backend)
    sizes = [50, 48, 45][:G]
    Xg = torch.zeros(G, B, genes)
    for g, sz in enumerate(sizes):
        Xg[g, :sz] = torch.from_numpy(X[50 * g : 50 * g + sz])
    masks = torch.arange(B)[None, :] < torch.tensor(sizes)[:, None]
    R = torch.from_numpy(np.random.default_rng(0).normal(size=(genes, K * 8)).astype(np.float32))
    out = fold_program(Xg, masks, sizes, R, True, **fold_static_args(cfg))
    return summaries_to_host(out, sizes, False)


def test_off_enters_no_record_function(monkeypatch):
    """With no profiler recording, a sharp() call and a fold_program call
    (ladder, tail, cut replay, wMetaC) open no record_function."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not timers.tracing()
    res = _small_call()
    _fold_group(1, B=512, backend="rnn")
    assert [r["stage"] for r in res.timing["stages"]] == STAGES
    assert timers.snapshot() == {"spans": {}, "host_reads": {}, "host_reads_under": {}, "sums": {}, "kernels": {}}


def _sharp_spans(prof):
    """The trace's `sharp.*` annotations -> [(name, its enclosing
    `sharp.*` annotations, innermost first)], read from the raw events (the
    profiler's parsed events are slow to build)."""
    evs = [(e.start_ns(), e.end_ns(), e.name(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation() and e.name().startswith("sharp.")]
    out = []
    for s, e, n, t in evs:
        outer = sorted((o for o in evs if o[3] == t and o[0] <= s and e <= o[1] and o != (s, e, n, t)),
                       key=lambda o: (o[0], -o[1]))
        out.append((n, [o[2] for o in reversed(outer)]))
    return out


def test_spans_nest_as_the_layers():
    """Under a CPU profile: the API span holds the small tier's stages
    (`res.timing` keeps its stages), which hold the ensemble's and wMetaC's
    parts; the fold program holds the RP product, the distances, the
    linkage with one span per ladder level and the tail, the cut replay,
    the selection and wMetaC's similarity and meta-problem. The ensemble's
    selection and the meta-problem's are different spans, in both layers.
    The tracer's span calls are the trace's."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _small_call()
        _fold_group(1, K=2, B=512, backend="rnn")
    assert [r["stage"] for r in res.timing["stages"]] == STAGES
    evs = _sharp_spans(prof)
    where = dict(reversed(evs))
    want = {
        "sharp.small.preprocess": ["sharp.api"],
        "sharp.small.ensemble_cluster.rp": ["sharp.small.ensemble_cluster", "sharp.api"],
        "sharp.small.ensemble_cluster.select": ["sharp.small.ensemble_cluster", "sharp.api"],
        "sharp.small.ensemble_cluster.linkage.ward_serial": ["sharp.small.ensemble_cluster.linkage"],
        "sharp.small.wmetac.meta.select": ["sharp.small.wmetac.meta", "sharp.small.wmetac", "sharp.api"],
        "sharp.small.log_decision.select": ["sharp.small.log_decision", "sharp.api"],
        "sharp.finalize_labels": ["sharp.small.finalize", "sharp.api"],
        "sharp.fold.rp": ["sharp.fold"],
        "sharp.fold.distance": ["sharp.fold"],
        "sharp.fold.linkage.level512": ["sharp.fold.linkage", "sharp.fold"],
        "sharp.fold.linkage.tail": ["sharp.fold.linkage", "sharp.fold"],
        "sharp.fold.cutree": ["sharp.fold"],
        "sharp.fold.select": ["sharp.fold"],
        "sharp.fold.wmetac.similarity": ["sharp.fold.wmetac", "sharp.fold"],
        "sharp.fold.wmetac.meta.select": ["sharp.fold.wmetac.meta", "sharp.fold.wmetac", "sharp.fold"],
        "sharp.fold.wmetac.meta.linkage.tail": ["sharp.fold.wmetac.meta.linkage"],
        "sharp.summaries_to_host": [],
    }
    for name, parents in want.items():
        assert name in where, name
        assert where[name][: len(parents)] == parents, (name, where[name])
    spans = timers.snapshot()["spans"]
    assert spans == {n[len("sharp."):]: sum(1 for e, _ in evs if e == n) for n in where}
    assert spans["fold"] == 1 and spans["api"] == 1 and len(evs) < 100


def test_host_reads_exact_and_not_growing_with_lanes():
    """A sharp() call on the small tier reads the host 7 times, all under
    the API span: the testlog's two silhouettes, the members' counts, the
    consensus, viE, x0 and the members' silhouettes. A fold group reads
    none in the fold program and one a field in its summaries, the same
    at G*K = 4 and 12 lanes."""
    with profile(activities=[ProfilerActivity.CPU]):
        _small_call()
    snap = timers.snapshot()
    assert snap["host_reads"] == SMALL_READS
    assert snap["host_reads_under"]["api"] == 7 and snap["spans"]["api"] == 1
    counts = []
    for G in (1, 3):
        timers.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            _fold_group(G)
        snap = timers.snapshot()
        counts.append((snap["host_reads_under"].get("fold", 0), snap["host_reads"]))
    assert counts[0] == counts[1] == (0, {"large.summaries": 7})


def _ladder_D(n=512, reals=(512, 200, 60), p=16):
    """L = 3 lanes at n_pad n with different real counts (so lanes leave a
    level at different rounds)."""
    rng = np.random.default_rng(7)
    Z = torch.zeros((len(reals), n, p))
    for i, r in enumerate(reals):
        Z[i, :r] = torch.from_numpy(rng.normal(size=(r, p)).astype(np.float32))
    mask = torch.arange(n)[None, :] < torch.tensor(reals)[:, None]
    D, _, _ = prep_distance(Z, mask, symmetric=False)
    return D.contiguous()


@pytest.mark.parametrize("read_every", [1, 8])
def test_ladder_live_lane_rounds(monkeypatch, read_every):
    """The live lane-rounds of a CPU ladder are the sum of its levels'
    `rounds` at each compaction; the launched ones L a round launched, the
    rounds between two reads included; the ladder's host reads are its
    `host_reads`."""
    levels = []
    real_compact = tlink.RnnLadder.compact

    def spy(self, Cn):
        levels.append(self.rounds.clone())
        return real_compact(self, Cn)

    monkeypatch.setattr(tlink.RnnLadder, "compact", spy)
    monkeypatch.setattr(tlink, "_read_every", lambda D, fused: read_every)
    D = _ladder_D()
    with profile(activities=[ProfilerActivity.CPU]):
        s = tlink.rnn_ladder(D, compact_n=64)
    snap = timers.snapshot()
    L = D.shape[0]
    assert len(levels) == 3
    assert snap["sums"]["ladder.live_lane_rounds"] == sum(int(r.sum()) for r in levels)
    launched = sum(read_every * math.ceil(int(r.max()) / read_every) for r in levels)
    assert snap["sums"]["ladder.launched_lane_rounds"] == L * launched
    assert snap["host_reads"] == {"ladder.active": s.host_reads}
    assert snap["sums"]["ladder.live_lane_rounds"] < snap["sums"]["ladder.launched_lane_rounds"]


def test_cutree_bytes_are_the_kernel_tables_bound():
    """(80, 2048), 39 candidates: 8.0 us at 3.35 TB/s, the kernel table's
    bound; a traced cut replay counts those bytes."""
    assert round(cutree_bytes(80, 2047, 39) / 3.35e12 * 1e6, 1) == 8.0
    merges = torch.stack([torch.zeros(15, dtype=torch.int32), torch.arange(1, 16, dtype=torch.int32)], 1)
    with profile(activities=[ProfilerActivity.CPU]):
        linkage_cuda.cutree_snapshots_kernel(merges.expand(3, 15, 2).contiguous(), 16, minN=2, ncand=5)
    snap = timers.snapshot()
    assert snap["kernels"]["cutree"] == {"bytes": cutree_bytes(3, 15, 5), "ms": 0}


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_round_bytes_at_most_round_bytes(monkeypatch, store):
    """The round bytes the ladder counts from its per-level sums are at
    most `chip_smoke.round_bytes`' bytes summed over the same rounds (each
    taken from the ladder's states before and after the round), and more
    than the rows a and b read alone."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    real_round = tlink.rnn_round
    total = {"bytes": 0, "rows": 0}

    def spy(ladder, nxt, P):
        ladder.row_cache()
        before = chip_smoke._ladder_copy(ladder)
        real_round(ladder, nxt, P)
        nb = chip_smoke.round_bytes(before, ladder, P)
        total["bytes"] += nb["bytes"]
        total["rows"] += 2 * nb["pairs"] * ladder.D.shape[-1] * ladder.D.element_size()

    monkeypatch.setattr(linkage_cuda, "rnn_round", spy)
    with profile(activities=[ProfilerActivity.CPU]):
        tlink.rnn_ladder(_ladder_D(), store_dtype=store, compact_n=64)
    counted = timers.snapshot()["kernels"]["rnn_round"]["bytes"]
    assert total["rows"] < counted <= total["bytes"]
