"""The jit-compiled part of the JAX package's surface against the port, on
the CPU: `ward_linkage_fast`, `ward_linkage_deferred` (every hmethod),
`ward_linkage_rnn`'s `tail`, `opt_hclust`'s `precomputed_link` and
`fold_program`'s `has_indN`.

The same seeded numpy inputs go through the JAX function and the port's.
Merges, labels and cluster counts must be identical; heights equal within
rtol 1e-6 (tests/test_linkage.py's bound: XLA on the CPU rounds the
Lance-Williams update in its own way, so heights differ in the last bit).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharp_tpu.config import resolve_config
from sharp_tpu.core import fold as jfold
from sharp_tpu.ops import linkage as jlink
from sharp_tpu.ops import select as jselect
from sharp_tpu.ops.distance import pearson_distance as jpearson
from sharp_tpu.ops.distance import standardize_rows as jstd
from sharp_tpu_torch.core import fold as tfold
from sharp_tpu_torch.ops import linkage as tlink
from sharp_tpu_torch.ops import select as tselect
from tests.synth import make_tpm_like
from torch_threads import one_torch_thread  # noqa: F401


def _distance(n, nreal, p=24, seed=7, tied=False):
    """A padded (n, n) Pearson distance of nreal seeded points, from the
    JAX package (the port reads the same float32 matrix). `tied` repeats
    every point four times: exact ties at every level of the tree."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, p), np.float32)
    if tied:
        X[:nreal] = np.repeat(rng.normal(size=(nreal // 4, p)), 4, axis=0)
    else:
        X[:nreal] = rng.normal(size=(nreal, p))
    mask = jnp.asarray(np.arange(n) < nreal)
    return np.array(jpearson(jstd(jnp.asarray(X), mask), mask))


CASES = {"64-50": (64, 50, False), "128-128": (128, 128, False), "tied-64-48": (64, 48, True)}
IMPLS = {
    "fast": (jlink.ward_linkage_fast, tlink.ward_linkage_fast),
    "deferred": (functools.partial(jlink.ward_linkage_deferred, flush=32),
                 functools.partial(tlink.ward_linkage_deferred, flush=32)),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("impl", IMPLS)
def test_serial_ward_entry_points_match_jax(impl, case):
    """ward.D through `ward_linkage_fast` / `ward_linkage_deferred` (the
    serial Ward kernel's entry points; its plain loop here): the real
    merges equal to the JAX package's, their heights within rtol 1e-6 (the
    order of the pads' merges, all at one structural distance, is each
    tie rule's own)."""
    n, nreal, tied = CASES[case]
    D = _distance(n, nreal, tied=tied)
    jf, tf = IMPLS[impl]
    ref = jf(jnp.asarray(D))
    got = tf(torch.from_numpy(D))
    np.testing.assert_array_equal(got.merges.numpy()[: nreal - 1], np.asarray(ref.merges)[: nreal - 1])
    np.testing.assert_allclose(got.heights.numpy()[: nreal - 1], np.asarray(ref.heights)[: nreal - 1], rtol=1e-6)
    assert got.merges.dtype == torch.int32 and got.heights.dtype == torch.float32


@pytest.mark.parametrize("method", sorted(tlink.MONOTONE_METHODS))
def test_deferred_linkage_every_monotone_method_matches_jax(method):
    D = _distance(64, 50, seed=3)
    ref = jlink.ward_linkage_deferred(jnp.asarray(D), method=method)
    got = tlink.ward_linkage_deferred(torch.from_numpy(D), method=method)
    np.testing.assert_array_equal(got.merges.numpy()[:49], np.asarray(ref.merges)[:49])
    np.testing.assert_allclose(got.heights.numpy()[:49], np.asarray(ref.heights)[:49], rtol=1e-6)


@pytest.mark.parametrize("method", ["median", "centroid"])
def test_deferred_linkage_refuses_a_non_monotone_method_as_jax(method):
    D = _distance(64, 50)
    with pytest.raises(ValueError, match="non-monotone"):
        jlink.ward_linkage_deferred(jnp.asarray(D), method=method)
    with pytest.raises(ValueError, match="non-monotone"):
        tlink.ward_linkage_deferred(torch.from_numpy(D), method=method)


def test_deferred_linkage_checks_its_loop_knobs():
    """flush, unroll and eager_w shape the JAX package's loop, not the
    result; what the JAX function fails on raises."""
    D = torch.from_numpy(_distance(64, 50))
    ref = tlink.ward_linkage_deferred(D)
    for kw in (dict(flush=1), dict(flush=500, unroll=4, eager_w=8), dict(unroll=0, eager_w=-1)):
        got = tlink.ward_linkage_deferred(D, **kw)
        assert torch.equal(got.merges, ref.merges) and torch.equal(got.heights, ref.heights)
    with pytest.raises(TypeError):
        jlink.ward_linkage_deferred(jnp.asarray(D.numpy()), flush=2.5)
    for kw, err in ((dict(flush=2.5), TypeError), (dict(flush=0), ValueError), (dict(eager_w=2.0), TypeError)):
        with pytest.raises(err):
            tlink.ward_linkage_deferred(D, **kw)


# JAX's compiled Pallas tail runs on a TPU only: its CPU counterpart is the
# same kernel in interpret mode
JAX_TAIL = {"auto": "auto", "xla": "xla", "pallas": "pallas_interpret", "pallas_interpret": "pallas_interpret"}


@pytest.fixture(scope="module")
def rnn_distance():
    return _distance(256, 240, seed=11)


@pytest.mark.parametrize("compact_n", [256, 64])
@pytest.mark.parametrize("tail", list(JAX_TAIL))
def test_rnn_tail_matches_jax(rnn_distance, tail, compact_n):
    """Every value of `tail`, with the whole problem in the tail (compact_n
    256) and after two ladder levels (64): the port's merges equal JAX's."""
    D = rnn_distance
    ref = jlink.ward_linkage_rnn(jnp.asarray(D), compact_n=compact_n, tail=JAX_TAIL[tail])
    got = tlink.ward_linkage_rnn(torch.from_numpy(D), compact_n=compact_n, tail=tail)
    np.testing.assert_array_equal(got.merges.numpy()[:239], np.asarray(ref.merges)[:239])
    np.testing.assert_allclose(got.heights.numpy()[:239], np.asarray(ref.heights)[:239], rtol=1e-6)


def test_rnn_tail_is_the_sixth_positional_parameter(rnn_distance):
    """`ward_linkage_rnn(D, 128, None, 256, 32, "xla")` names the tail in
    both packages; round_impl "pallas_interpret" takes the route of
    "pallas"; an unknown tail raises."""
    D = torch.from_numpy(rnn_distance)
    ref = jlink.ward_linkage_rnn(jnp.asarray(rnn_distance), 128, None, 64, 32, "xla")
    got = tlink.ward_linkage_rnn(D, 128, None, 64, 32, "xla")
    np.testing.assert_array_equal(got.merges.numpy()[:239], np.asarray(ref.merges)[:239])
    fused = tlink.ward_linkage_rnn(D, compact_n=64, round_impl="pallas")
    interp = tlink.ward_linkage_rnn(D, compact_n=64, round_impl="pallas_interpret")
    assert torch.equal(fused.merges, interp.merges) and torch.equal(fused.heights, interp.heights)
    with pytest.raises(ValueError, match="tail"):
        tlink.ward_linkage_rnn(D, tail="serial")


@pytest.fixture(scope="module")
def hclust_case():
    X, _ = make_tpm_like(n_cells=100, n_genes=40, n_types=4, seed=5)
    mat = np.zeros((128, 40), np.float32)
    mat[:100] = np.log2(X + 1)
    mask = np.arange(128) < 100
    kw = dict(symmetric=False, minN=2, ncand=19, nc_pad=24)
    return mat, mask, kw


@pytest.mark.parametrize("source", ["jax", "port"])
def test_opt_hclust_precomputed_link_matches_jax(hclust_case, source):
    """opt_hclust with the merge sequence given (JAX's linkage or the
    port's): labels, k and maxsil equal to JAX's own call."""
    mat, mask, kw = hclust_case
    ref = jselect.opt_hclust(jnp.asarray(mat), jnp.asarray(mask), jnp.asarray(100), jnp.asarray(20), **kw)
    Dj = jselect._prep_distance(jnp.asarray(mat), jnp.asarray(mask), False)[0]
    if source == "jax":
        jl = jlink.ward_linkage(Dj)
        link = tlink.LinkageResult(torch.from_numpy(np.array(jl.merges)), torch.from_numpy(np.array(jl.heights)))
    else:
        link = tlink.ward_linkage(torch.from_numpy(np.array(Dj)))
    got = tselect.opt_hclust(torch.from_numpy(mat), torch.from_numpy(mask), 100, 20,
                             precomputed_link=link, **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    assert int(got.k) == int(ref.k)
    np.testing.assert_allclose(float(got.maxsil), float(ref.maxsil), atol=1e-5)
    # a lane axis: the link carries it too, and a wrong shape raises
    lanes = tselect.opt_hclust(torch.from_numpy(mat)[None].expand(2, -1, -1), torch.from_numpy(mask), 100, 20,
                               precomputed_link=tlink.LinkageResult(link.merges[None].expand(2, -1, -1),
                                                                    link.heights[None].expand(2, -1)), **kw)
    assert (lanes.labels == got.labels).all() and (lanes.k == got.k).all()
    with pytest.raises(ValueError, match="precomputed_link"):
        tselect.opt_hclust(torch.from_numpy(mat)[None].expand(2, -1, -1), torch.from_numpy(mask), 100, 20,
                           precomputed_link=link, **kw)


@pytest.fixture(scope="module")
def indN_case():
    """One fold (180 real cells of 256, 200 genes, K=3) and the JAX fold
    program with indN_cluster=6, without and with has_indN."""
    from tests.test_torch_large import _jax_draws

    genes, B = 200, 256
    cfg = resolve_config(180, genes, ensize_K=3, partition_ncells=200, rN_seed=5)
    static = jfold.fold_static_args(cfg)
    R = _jax_draws(180, genes, 3, cfg.reduced_ndim, 5)["R"]
    X, _ = make_tpm_like(n_cells=180, n_genes=genes, n_types=4, seed=13)
    Xp = np.zeros((B, genes), np.float32)
    Xp[:180] = X
    mask = np.arange(B) < 180
    args = (jnp.asarray(Xp), jnp.asarray(mask), jnp.asarray(180), jnp.asarray(R), jnp.asarray(True),
            jnp.asarray(6))
    refs = {has: jfold.fold_program(*args, has_indN=has, **static) for has in (False, True)}
    targs = (torch.from_numpy(Xp), torch.from_numpy(mask), 180, torch.from_numpy(R), True)
    return cfg, targs, refs


def _same_fold(got, ref, garbage):
    from tests.test_torch_large import _relabel

    np.testing.assert_array_equal(_relabel(got.finalC.numpy(), garbage)[0],
                                  _relabel(np.asarray(ref.finalC), garbage)[0])
    np.testing.assert_array_equal(got.k_per.numpy(), np.asarray(ref.k_per))
    np.testing.assert_allclose(got.maxsil.numpy(), np.asarray(ref.maxsil), atol=1e-5)
    assert int(got.n_meta) == int(ref.n_meta)


def test_fold_program_ignores_indN_cluster_without_has_indN_as_jax(indN_case):
    """`fold_program(..., indN_cluster=6)` clusters with free k unless
    `has_indN=True` (sharp_tpu/core/fold.py:91): equal to JAX's call and
    to the port's with indN_cluster=None."""
    cfg, targs, refs = indN_case
    static = tfold.fold_static_args(cfg)
    got = tfold.fold_program(*targs, 6, **static)
    free = tfold.fold_program(*targs, None, **static)
    _same_fold(got, refs[False], cfg.nc_pad - 1)
    assert torch.equal(got.finalC, free.finalC) and torch.equal(got.k_per, free.k_per)
    assert (np.asarray(refs[False].k_per) != 6).any()


def test_fold_program_with_has_indN_fixes_k_as_jax(indN_case):
    cfg, targs, refs = indN_case
    got = tfold.fold_program(*targs, 6, has_indN=True, **tfold.fold_static_args(cfg))
    _same_fold(got, refs[True], cfg.nc_pad - 1)
    assert (got.k_per == 6).all()
