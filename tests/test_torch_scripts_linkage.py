"""The port's linkage tuning scripts on the CPU, held against the JAX side:
`scripts/tune_linkage_rnn_torch.py`, `bench_linkage_backends_torch.py` and
`profile_fold_torch.py`.

Inputs are the scripts' own numpy draws at small sizes (n_pad 256, p 16 or
a few hundred genes), and the JAX package's distances and RP matrix go to
both sides. Merge indices are integers: the real merges (the first n_real
- 1; the pads merge among themselves at tied heights near 1e20) must be
identical, and the heights agree within rtol 1e-6, the tolerance of
tests/test_torch_rnn.py for f32 and bf16 storage (XLA may contract the
Lance-Williams step into fused multiply-adds), with the cuts identical.
The fold program's labels, chosen k and n_meta are integers and must be
identical; with bf16 storage, as the oracle rule says, the comparison is
at the cuts (each member's k, n_meta) and the ARI (1.0) of the fold's
labels. One torch thread.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharp_tpu.config import resolve_config as j_resolve_config
from sharp_tpu.core import fold as jfold
from sharp_tpu.ops import distance as jdist
from sharp_tpu.ops import linkage as jlink
from sharp_tpu.ops.rp import ensemble_rp_matrix as j_rp_matrix
from sharp_tpu_torch.analysis.ari import ari
from sharp_tpu_torch.ops import distance as tdist
from sharp_tpu_torch.ops import linkage as tlink
from tests.synth import make_tpm_like
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))

import bench_linkage_backends_torch as blb  # noqa: E402
import profile_fold_torch as pf  # noqa: E402
import tune_linkage_rnn as jtune  # noqa: E402  (the JAX script: jax only inside its main)
import tune_linkage_rnn_torch as tune  # noqa: E402

CPU = torch.device("cpu")
N_PAD, N_REAL = 256, 230
STORES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _jax_distances(X, mask):
    m = jnp.asarray(mask)
    return np.array(jax.vmap(lambda x: jdist.pearson_distance(x, m))(jnp.asarray(X)))


def _cuts(merges, nreal, n):
    mask = np.arange(n) < nreal
    return np.asarray(jlink.cutree_multi(
        jnp.asarray(np.asarray(merges)), jnp.asarray(nreal), jnp.asarray(mask), jnp.asarray(40),
        minN=2, ncand=39, nc_pad=48,
    ).labels)


def _same_link(got, ref, nreal, n):
    k = nreal - 1
    np.testing.assert_array_equal(got.merges.numpy()[:k], np.asarray(ref.merges)[:k])
    np.testing.assert_allclose(got.heights.float().numpy()[:k], np.asarray(ref.heights, np.float32)[:k],
                               rtol=1e-6)
    np.testing.assert_array_equal(_cuts(got.merges.numpy(), nreal, n), _cuts(ref.merges, nreal, n))


@pytest.fixture(scope="module")
def grid_points():
    """The tune script's points at (2 lanes, n_pad 256), p 16, and the JAX
    package's distances of them."""
    X, mask = tune.make_points(lanes=2, n_pad=N_PAD, p=16, n_real=N_REAL)
    return _jax_distances(X, mask)


@pytest.mark.parametrize("pair_cap", [16, 32, 128])
def test_host_round_counts_is_the_jax_scripts(grid_points, pair_cap):
    D0 = grid_points[0].astype(np.float64)
    got = tune.host_round_counts(D0.copy(), pair_cap, 64, 32)
    assert got == jtune.host_round_counts(D0.copy(), pair_cap, 64, 32)
    assert [lvl for lvl, _ in got] == [256, 128, 64]


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_reduced_grid_matches_jax_ward_linkage_rnn(grid_points, store):
    """(pair_cap {32, 128} x compact_n {64, 128}): the script's grid (which
    raises unless both compact_cap values give identical merges and every
    lane's sequence is valid) against JAX's ward_linkage_rnn with the same
    knobs, lane by lane. With bf16 storage the JAX side drains through its
    serial tail kernel (interpreted), which the port's tail ports: its
    round-based XLA tail (compact_cap pairs a round) rounds the pair-pair
    entries in another association, and on these points its merges differ
    from its own serial tail's in 2-15 of a lane's 229 real merges."""
    tst, jst = STORES[store]
    tail = "pallas_interpret" if store == "bf16" else "auto"
    points, links = tune.grid(torch.from_numpy(grid_points), N_REAL, CPU, (32, 128), (64, 128), (32, 64),
                              store=tst, reps=1, folds=1)
    assert [(q["pair_cap"], q["compact_n"]) for q in points] == [(32, 64), (32, 128), (128, 64), (128, 128)]
    assert all(q["valid"] and q["compact_caps_identical"] for q in points)
    Dj = jnp.asarray(grid_points)
    for (pc, cn), link in links.items():
        ref = jax.vmap(lambda d: jlink.ward_linkage_rnn(d, pair_cap=pc, store_dtype=jst, compact_n=cn,
                                                        compact_cap=32, tail=tail))(Dj)
        for lane in range(2):
            _same_link(tlink.LinkageResult(link.merges[lane], link.heights[lane]),
                       jlink.LinkageResult(ref.merges[lane], ref.heights[lane]), N_REAL, N_PAD)
            assert tlink.validate_merge_sequence(link.merges[lane], link.heights[lane], N_REAL, N_PAD) == []


def test_port_rounds_per_level_beside_the_replica(grid_points):
    """The port's real rounds per level (f32) on the first lane: the same
    levels as the replica, at least one round each, and the tail's serial
    merges last (n_alive - 1 of the at most 64 compacted survivors)."""
    rec = tune.replica(torch.from_numpy(grid_points), (32,), compact_n=64)[0]
    assert [lvl for lvl, _ in rec["port"][:-1]] == [lvl for lvl, _ in rec["replica"][:-1]] == [256, 128]
    assert all(r >= 1 for _, r in rec["port"][:-1])
    assert rec["port"][-1][0] == 64 and 1 <= rec["port"][-1][1] <= 63


@pytest.fixture(scope="module")
def backend_points():
    X, mask = blb.make_points(np.random.default_rng(blb.SEED), N_PAD, N_REAL, K=2, p=16)
    return X, mask, _jax_distances(X, mask)


def test_backends_distances_and_ladder_match_jax(backend_points):
    X, mask, Dj = backend_points
    Dt = tdist.pearson_distance(torch.from_numpy(X), torch.from_numpy(mask))
    np.testing.assert_allclose(Dt.numpy(), Dj, atol=1e-6, rtol=0)
    got = tlink.ward_linkage_rnn(torch.from_numpy(Dj))
    ref = jax.vmap(jlink.ward_linkage_rnn)(jnp.asarray(Dj))
    for lane in range(2):
        _same_link(tlink.LinkageResult(got.merges[lane], got.heights[lane]),
                   jlink.LinkageResult(ref.merges[lane], ref.heights[lane]), N_REAL, N_PAD)


def test_backends_serial_f32_equals_the_f32_ladder(backend_points):
    """The script's four rows on the CPU (their plain versions): it raises
    unless every sequence is valid and serial f32's real merges are the f32
    ladder's; the two serial rows are serial Ward in f32 and bf16 storage."""
    X, mask, _ = backend_points
    row, links = blb.one_size(X, mask, CPU, r=1)
    assert row["serial_f32_equals_rnn_f32"] and set(row["ms"]) == set(blb.BACKENDS)
    D = tdist.pearson_distance(torch.from_numpy(X), torch.from_numpy(mask))
    for name, store in (("serial f32", torch.float32), ("serial bf16", torch.bfloat16)):
        ref = tlink.ward_linkage(D, store_dtype=store)
        assert torch.equal(links[name].merges, ref.merges) and torch.equal(links[name].heights, ref.heights)


def test_tied_swaps_accepts_only_reordered_ties():
    """The backends gate: two merges at one height may come in either
    order; any other difference fails."""
    m = np.array([[0, 1], [2, 3], [4, 5], [0, 2]])
    h = np.array([0.1, 0.2, 0.2, 0.3], np.float32)
    assert blb.tied_swaps(m, h, m.copy(), h.copy()) == 0
    swapped = m[[0, 2, 1, 3]]
    assert blb.tied_swaps(m, h, swapped, h.copy()) == 2
    h_untied = np.array([0.1, 0.2, 0.25, 0.3], np.float32)
    assert blb.tied_swaps(m, h_untied, swapped, h_untied) is None
    other = m.copy()
    other[3] = [0, 4]
    assert blb.tied_swaps(m, h, other, h) is None


def _fold_inputs():
    """Two lanes of 256 cells x 300 genes (tests/synth.py, seed 29) and the
    JAX package's RP matrix (K=2, p=16) in bf16, as the script's."""
    X, _ = make_tpm_like(n_cells=2 * N_PAD, n_genes=300, n_types=5, seed=29)
    X = X.reshape(2, N_PAD, 300).astype(np.float32)
    R = np.array(j_rp_matrix(jax.random.PRNGKey(7), 2, 300, 16, dtype=jnp.bfloat16).astype(jnp.float32))
    return X, R


@pytest.mark.parametrize("backend", ["rnn", "rnn_bf16"])
def test_fold_program_per_backend_matches_jax(backend):
    """The script's profile over one group of 2 folds (the JAX script's
    masks: every lane all true, its real count 250) against JAX's vmapped
    fold_program on the same folds and RP matrix."""
    X, R = _fold_inputs()
    cfg = pf.config(pf.N_CELLS, 300, 2, 16)
    rec, outs = pf.profile(lambda t0, sizes: (torch.from_numpy(X), None), torch.from_numpy(R).to(torch.bfloat16),
                           cfg, 2, CPU, backends=(backend,), timed_groups=1, n_real=250)
    assert rec[backend]["first_s"] > 0 and len(rec[backend]["group_ms"]) == 1
    jcfg = j_resolve_config(pf.N_CELLS, 300, ensize_K=2, reduced_ndim=16, partition_ncells=2000, rN_seed=7,
                            dtype_compute="bfloat16", forview=False)
    static = dict(jfold.fold_static_args(jcfg), linkage_backend=backend)
    Rj = jnp.asarray(R, jnp.bfloat16)
    ref = jax.vmap(lambda x, m, nr: jfold.fold_program(x, m, nr, Rj, jnp.asarray(True), None, has_indN=False,
                                                       **static))(
        jnp.asarray(X), jnp.ones((2, N_PAD), bool), jnp.full((2,), 250, jnp.int32))
    got = outs[backend]
    np.testing.assert_array_equal(got["k_per"], np.asarray(ref.k_per))
    np.testing.assert_array_equal(got["n_meta"], np.asarray(ref.n_meta))
    if backend == "rnn":
        np.testing.assert_array_equal(got["finalC"], np.asarray(ref.finalC))
    else:
        for g in range(2):
            assert ari(np.asarray(ref.finalC)[g, :250], got["finalC"][g, :250]) == 1.0
