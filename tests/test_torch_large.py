"""Parity of the port's large tier with the JAX package, on the CPU.

The fold program, sMetaC, the cross-fold fuse and `sharp()` on the large
tier (forced at small sizes by a low base_ncells / partition_ncells, as
tests/test_large.py does) get the same seeded numpy data and the same
random draws in both packages: the JAX package makes the RP matrices, the
testlog probe and the cell reshuffle, and the port takes them through
`sharp_tpu_torch.carry`. Labels, cluster counts, member counts and fold
assignments are integers and must be identical; float32 summaries agree
within the tolerances of tests/test_torch_pipeline.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharp_tpu
import sharp_tpu_torch
from sharp_tpu.config import resolve_config
from sharp_tpu.core import fold as jfold
from sharp_tpu.core import large as jlarge
from sharp_tpu.core import smetac as jsmetac
from sharp_tpu.ops.rp import ensemble_rp_matrix, ternary_rp_matrix
from sharp_tpu.utils import prng as jprng
from sharp_tpu_torch import carry
from sharp_tpu_torch.core import fold as tfold
from sharp_tpu_torch.core import large as tlarge
from sharp_tpu_torch.core import smetac as tsmetac
from sharp_tpu_torch.parallel.sharded import auto_group, process_folds_grouped
from tests.synth import make_tpm_like
from tests.test_large import _fake_fold_results
from torch_threads import one_torch_thread  # noqa: F401


def _jax_draws(n, genes, K, p, rN_seed):
    key = jprng.seed_to_key(rN_seed)
    return dict(
        R=np.array(ensemble_rp_matrix(key, K, genes, p)),
        testlog_perm=np.asarray(jax.random.permutation(jprng.testlog_key(key), n, independent=True)),
        R_probe=np.asarray(ternary_rp_matrix(jax.random.PRNGKey(5), genes, p)),
        shuffle_perm=np.asarray(jax.random.permutation(jprng.shuffle_key(key), n, independent=True)),
    )


def _relabel(lab, garbage):
    """Labels renumbered by first occurrence; the garbage slot keeps its id."""
    out = np.full_like(lab, garbage)
    mapping = {}
    for i, v in enumerate(lab):
        if v != garbage:
            out[i] = mapping.setdefault(int(v), len(mapping))
    return out, mapping


@pytest.fixture(scope="module")
def fold_case():
    """Two folds (200 and 170 real cells of 256, 300 genes, K=3) through the
    JAX fold program one at a time and through the port's as one group."""
    genes, K, B = 300, 3, 256
    cfg = resolve_config(370, genes, ensize_K=K, partition_ncells=200, rN_seed=3)
    static = jfold.fold_static_args(cfg)
    R = _jax_draws(370, genes, K, cfg.reduced_ndim, 3)["R"]
    X, _ = make_tpm_like(n_cells=370, n_genes=genes, n_types=4, seed=11)
    sizes = [200, 170]
    Xg = np.zeros((2, B, genes), np.float32)
    Xg[0, :200], Xg[1, :170] = X[:200], X[200:]
    masks = np.arange(B)[None, :] < np.array(sizes)[:, None]
    refs = [
        jfold.fold_program(
            jnp.asarray(Xg[g]), jnp.asarray(masks[g]), jnp.asarray(sizes[g]), jnp.asarray(R),
            jnp.asarray(True), None, has_indN=False, **static,
        )
        for g in range(2)
    ]
    got = tfold.fold_program(
        torch.from_numpy(Xg), torch.from_numpy(masks), sizes, torch.from_numpy(R), True,
        None, **tfold.fold_static_args(cfg),
    )
    return dict(cfg=cfg, sizes=sizes, refs=refs, got=got, X=X, R=R, static=static)


def test_fold_program_matches_jax(fold_case):
    cfg, got = fold_case["cfg"], fold_case["got"]
    garbage = cfg.nc_pad - 1
    for g, ref in enumerate(fold_case["refs"]):
        mine, mp = _relabel(got.finalC[g].numpy(), garbage)
        theirs, tp = _relabel(np.asarray(ref.finalC), garbage)
        np.testing.assert_array_equal(mine, theirs)
        # cluster slots matched through the relabelling
        order_m = [c for c, _ in sorted(mp.items(), key=lambda kv: kv[1])]
        order_t = [c for c, _ in sorted(tp.items(), key=lambda kv: kv[1])]
        np.testing.assert_array_equal(got.counts[g].numpy()[order_m], np.asarray(ref.counts)[order_t])
        np.testing.assert_allclose(
            got.cent_sum[g].numpy()[order_m], np.asarray(ref.cent_sum)[order_t], rtol=1e-5, atol=1e-4
        )
        np.testing.assert_allclose(
            got.x0[g].numpy()[:, order_m], np.asarray(ref.x0)[:, order_t], atol=1e-6
        )
        assert int(got.n_meta[g]) == int(ref.n_meta)
        assert bool(got.overflow[g]) == bool(ref.overflow)
        np.testing.assert_array_equal(got.k_per[g].numpy(), np.asarray(ref.k_per))
        np.testing.assert_allclose(got.maxsil[g].numpy(), np.asarray(ref.maxsil), atol=1e-5)
        np.testing.assert_allclose(got.mean_proj[g].numpy(), np.asarray(ref.mean_proj), rtol=1e-5, atol=1e-4)


def test_fold_groups_do_not_change_results(fold_case):
    """One fold per call and all folds in one call give the same summaries."""
    cfg, X, R = fold_case["cfg"], fold_case["X"], torch.from_numpy(fold_case["R"])
    runs = [
        process_folds_grouped(X, fold_case["sizes"], 256, R, cfg, True, group=g, device="cpu")
        for g in (1, 2)
    ]
    for a, b in zip(*runs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    assert auto_group(2048, 27998, K=5, device="cpu") == 4    # an 8 GiB budget on the CPU
    assert auto_group(256, 300, K=3, device="cpu") == 16


def test_fold_sizes_and_smetac_range_match_jax():
    for n, part in ((4000, 2000), (4100, 2000), (1500, 2000), (50000, 2000), (1306127, 2000)):
        assert tlarge.fold_sizes(n, part) == jlarge.fold_sizes(n, part)
    for args in ((50000, 2, 40, 250), (2_000_000, 2, 40, 900), (30000, 3, 40, 12), (8000, 2, 40, 4)):
        assert tsmetac.smetac_range(*args) == jsmetac.smetac_range(*args)


@pytest.mark.parametrize("T", [1, 4])
def test_fuse_folds_matches_jax(T):
    rng = np.random.default_rng(5 + T)
    cfg = resolve_config(40000, 1000, ensize_K=3, reduced_ndim=32, partition_ncells=500)
    frs = _fake_fold_results(rng, T=T, nclust=6, nc_pad=cfg.nc_pad, p=32, n_fold=500)
    for fr in frs:
        fr["mean_proj"] = rng.normal(size=(500, 32)).astype(np.float32)
        fr["x0"] = rng.random((500, cfg.nc_pad)).astype(np.float32)
    ref = jlarge.fuse_folds(frs, cfg)
    got = tlarge.fuse_folds(frs, cfg, device="cpu")
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.n_final == ref.n_final
    np.testing.assert_allclose(got.cents, ref.cents, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.counts, ref.counts)
    np.testing.assert_allclose(got.x0, ref.x0, atol=1e-6)


def test_fuse_folds_takes_n_total_third_as_jax():
    """`fuse_folds(frs, cfg, N)` and `fuse_folds(frs, cfg, n_total=N)`: the
    third parameter is the block's cell count, unused, in both packages (it
    once became `finalN_cluster` in the port and forced N clusters)."""
    rng = np.random.default_rng(9)
    cfg = resolve_config(40000, 1000, ensize_K=3, reduced_ndim=32, partition_ncells=500)
    frs = _fake_fold_results(rng, T=4, nclust=6, nc_pad=cfg.nc_pad, p=32, n_fold=500)
    ref = jlarge.fuse_folds(frs, cfg, 2000)
    assert ref.n_final > 1
    for got in (tlarge.fuse_folds(frs, cfg, 2000, device="cpu"),
                tlarge.fuse_folds(frs, cfg, n_total=2000, device="cpu"),
                tlarge.fuse_folds(frs, cfg, 2000, None, device="cpu")):
        np.testing.assert_array_equal(got.labels, ref.labels)
        assert got.n_final == ref.n_final
    fixed, jfixed = tlarge.fuse_folds(frs, cfg, 2000, 3, device="cpu"), jlarge.fuse_folds(frs, cfg, 2000, 3)
    np.testing.assert_array_equal(fixed.labels, jfixed.labels)
    assert fixed.n_final == jfixed.n_final


def test_fuse_blocks_group_bounds_each_call():
    """`fuse_blocks(..., group)` fuses at most `group` blocks a call, as
    the JAX package's: the same results for every group."""
    rng = np.random.default_rng(4)
    cfg = resolve_config(40000, 1000, ensize_K=3, reduced_ndim=32, partition_ncells=500)
    blocks = [_fake_fold_results(rng, T=4, nclust=6, nc_pad=cfg.nc_pad, p=32, n_fold=500) for _ in range(5)]
    ref = jlarge.fuse_blocks(blocks, cfg, None, 3)
    calls = []
    real = tlarge.smetac

    def counted(cents, *a, **k):
        calls.append(cents.shape[0])
        return real(cents, *a, **k)

    tlarge.smetac = counted
    try:
        runs = {g: tlarge.fuse_blocks(blocks, cfg, None, g, device="cpu") for g in (1, 2, 8)}
    finally:
        tlarge.smetac = real
    assert max(calls) <= 8 and len(calls) >= 5 + 3
    for got in runs.values():
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.labels, b.labels)
            assert a.n_final == b.n_final


@pytest.mark.parametrize("indN", [None, 3])
def test_process_fold_and_summary_to_host_match_jax(indN):
    """One fold (170 real cells of 256) through each package's one-fold
    program, the port's a group of one through its fold program, with the
    JAX package's RP matrices; `indN_cluster` is kept. Then each package's
    `summary_to_host` of one fold summary, without the view planes."""
    genes, K, B, n = 300, 3, 256, 170
    cfg = resolve_config(n, genes, ensize_K=K, partition_ncells=200, rN_seed=3, indN_cluster=indN)
    R = _jax_draws(n, genes, K, cfg.reduced_ndim, 3)["R"]
    X, _ = make_tpm_like(n_cells=n, n_genes=genes, n_types=4, seed=11)
    ref = jlarge.process_fold(X, n, B, jnp.asarray(R), cfg, True)
    got = tlarge.process_fold(X, n, B, torch.from_numpy(R), cfg, True, device="cpu")
    assert got.keys() == ref.keys() and "x0" in got
    garbage = cfg.nc_pad - 1
    mine, mp = _relabel(got["finalC"], garbage)
    theirs, tp = _relabel(ref["finalC"], garbage)
    np.testing.assert_array_equal(mine, theirs)
    order_m = [c for c, _ in sorted(mp.items(), key=lambda kv: kv[1])]
    order_t = [c for c, _ in sorted(tp.items(), key=lambda kv: kv[1])]
    np.testing.assert_array_equal(got["counts"][order_m], ref["counts"][order_t])
    assert got["n_meta"] == ref["n_meta"] and got["overflow"] == ref["overflow"]
    np.testing.assert_array_equal(got["k_per"], ref["k_per"])
    if indN is not None:
        assert (got["k_per"] == indN).all()
    np.testing.assert_allclose(got["maxsil"], ref["maxsil"], atol=1e-5)
    for k in ("mean_proj", "x0"):
        assert got[k].shape == ref[k].shape
    np.testing.assert_allclose(got["mean_proj"], ref["mean_proj"], rtol=1e-5, atol=1e-4)

    static = jfold.fold_static_args(cfg)
    Xp = np.zeros((B, genes), np.float32)
    Xp[:n] = X
    mask = np.arange(B) < n
    js = jfold.fold_program(jnp.asarray(Xp), jnp.asarray(mask), jnp.asarray(n), jnp.asarray(R),
                            jnp.asarray(True), None, has_indN=False, **static)
    ts = tfold.fold_program(torch.from_numpy(Xp), torch.from_numpy(mask), n, torch.from_numpy(R), True,
                            None, **tfold.fold_static_args(cfg))
    a, b = tlarge.summary_to_host(ts, n, forview=False), jlarge.summary_to_host(js, n, forview=False)
    assert a.keys() == b.keys() and "x0" not in a
    assert a["finalC"].shape == b["finalC"].shape == (n,)
    assert a["n_meta"] == b["n_meta"] and type(a["overflow"]) is type(b["overflow"]) is bool
    np.testing.assert_array_equal(a["k_per"], b["k_per"])
    # the batched pull gives the same dicts
    batched = tlarge.summaries_to_host(tfold.FoldSummary(*(x[None] for x in ts)), [n], False)[0]
    for k in a:
        np.testing.assert_array_equal(np.asarray(batched[k]), np.asarray(a[k]))


def test_smetac_matches_jax():
    rng = np.random.default_rng(2)
    NC, NC_pad, p = 37, 64, 24
    cents = np.zeros((NC_pad, p), np.float32)
    cents[:NC] = np.repeat(rng.normal(size=(6, p)) * 3.0, 7, axis=0)[:NC] + rng.normal(size=(NC, p))
    valid = np.arange(NC_pad) < NC
    kw = dict(minN=2, ncand=30, meta_nc_pad=40, sil_thre=0.35, height_Ntimes=2.0)
    ref = jsmetac.smetac(jnp.asarray(cents), jnp.asarray(valid), jnp.asarray(NC), jnp.asarray(30), **kw)
    got = tsmetac.smetac(torch.from_numpy(cents), torch.from_numpy(valid), NC, 30, **kw)
    np.testing.assert_array_equal(got.tf.numpy(), np.asarray(ref.tf))
    assert got.n_final == int(ref.n_final)
    assert got.oind == int(ref.oind)
    assert float(got.maxsil) == pytest.approx(float(ref.maxsil), abs=1e-5)


def test_smetac_second_best_override_ranks_valid_candidates(monkeypatch):
    """The 2-cluster second-best-silhouette override (R/sMetaC.R:139-147)
    ranks only valid candidates, as the JAX package's test pins
    (tests/test_large.py): msil [0.9, 0.2, 0.1, 0.8, 0.0] with slots 3-4
    invalid picks candidate 1."""
    from sharp_tpu_torch.ops.select import OptHclust

    ncand, NC_pad = 5, 8
    all_labels = torch.arange(ncand, dtype=torch.int32)[:, None].repeat(1, NC_pad)

    def fake_opt_hclust(*a, **kw):
        # smetac clusters its blocks as lanes of one opt_hclust call: one lane here
        one = OptHclust(
            labels=all_labels[0], k=torch.tensor(2), maxsil=torch.tensor(0.9),
            msil=torch.tensor([0.9, 0.2, 0.1, 0.8, 0.0]), ch=torch.zeros(ncand),
            oind=torch.tensor(0), heights=torch.zeros(NC_pad - 1),
            all_labels=all_labels, valid=torch.tensor([True, True, True, False, False]),
        )
        return OptHclust(*(x[None] for x in one))

    monkeypatch.setattr(tsmetac, "opt_hclust", fake_opt_hclust)
    cents = torch.from_numpy(np.random.default_rng(0).normal(size=(NC_pad, 16)).astype(np.float32))
    res = tsmetac.smetac(cents, torch.ones(NC_pad, dtype=torch.bool), NC_pad, 4,
                         minN=3, ncand=ncand, meta_nc_pad=24, sil_thre=0.35)
    assert res.oind == 1
    fixed = tsmetac.smetac(cents, torch.ones(NC_pad, dtype=torch.bool), NC_pad, 4,
                           minN=3, ncand=ncand, meta_nc_pad=24, finalN_cluster=2)
    assert fixed.oind == 0


LARGE_CASES = {
    "auto_pad256": (900, 300, 5, 3, dict(rN_seed=7, base_ncells=400, partition_ncells=250, ensize_K=4)),
    "rnn_pad512": (1000, 300, 5, 4, dict(rN_seed=9, base_ncells=400, partition_ncells=400, ensize_K=3,
                                         linkage_backend="rnn")),
}


@pytest.fixture(scope="module", params=sorted(LARGE_CASES))
def large_case(request):
    n, genes, types, seed, kw = LARGE_CASES[request.param]
    kw = dict(kw, prep=False)
    X, y = make_tpm_like(n_cells=n, n_genes=genes, n_types=types, seed=seed)
    cfg = resolve_config(n, genes, **kw)
    d = _jax_draws(n, genes, cfg.ensize_K, cfg.reduced_ndim, kw["rN_seed"])
    ref = sharp_tpu.sharp(X, rM=d["R"], **kw)
    got = sharp_tpu_torch.sharp(
        X, rM=d["R"], device="cpu",
        testlog_probe=carry.testlog_probe_from_jax(d["testlog_perm"], d["R_probe"], n, genes, cfg.reduced_ndim, device="cpu"),
        shuffle_perm=carry.shuffle_perm_from_jax(d["shuffle_perm"], n),
        **kw,
    )
    return dict(ref=ref, got=got)


def test_sharp_large_tier_matches_jax(large_case):
    ref, got = large_case["ref"], large_case["got"]
    np.testing.assert_array_equal(got.pred_clusters, ref.pred_clusters)
    np.testing.assert_array_equal(got.per_member_k, ref.per_member_k)
    np.testing.assert_array_equal(got.folds, ref.folds)
    assert got.N_pred_cluster == ref.N_pred_cluster
    assert got.distr_pred_clusters == ref.distr_pred_clusters
    np.testing.assert_allclose(got.per_member_maxsil, ref.per_member_maxsil, atol=1e-5)
    np.testing.assert_allclose(got.viE, ref.viE, rtol=1e-5, atol=1e-4)
    assert [s["stage"] for s in got.timing["stages"]] == [
        "preprocess", "log_decision", "permute_partition", "rp_setup", "fold_ensemble", "smetac", "finalize",
    ]


def test_sharp_large_tier_own_draws():
    """The port's own draws on the large tier: reproducible per seed, every
    cell in a fold, labels 1..k."""
    n = 900
    X, y = make_tpm_like(n_cells=n, n_genes=300, n_types=5, seed=3)
    kw = dict(rN_seed=2, base_ncells=400, partition_ncells=300, ensize_K=3, device="cpu")
    a = sharp_tpu_torch.sharp(X, **kw)
    b = sharp_tpu_torch.sharp(X, **kw)
    np.testing.assert_array_equal(a.pred_clusters, b.pred_clusters)
    assert sorted(np.unique(a.folds)) == list(range(len(tlarge.fold_sizes(n, 300))))
    u = np.unique(a.pred_clusters)
    assert np.array_equal(u, np.arange(1, len(u) + 1))
    with pytest.raises(ValueError, match="shuffle_perm"):
        sharp_tpu_torch.sharp(X, shuffle_perm=torch.arange(n - 1), **kw)


@pytest.mark.parametrize("n,partition_ncells", [(900, 250), (450, 500)])
def test_indN_cluster_holds_for_one_fold_only_as_in_jax(n, partition_ncells):
    """indN_cluster fixes every member's cluster count in a call of one fold
    (450 cells in folds of 500: T = 1) and is dropped by the grouped pass
    of two or more (900 in folds of 250: T = 4), as the JAX package does:
    member counts and labels identical to `sharp_tpu.sharp` with the same
    draws."""
    genes = 300
    X, _ = make_tpm_like(n_cells=n, n_genes=genes, n_types=5, seed=3)
    kw = dict(rN_seed=7, base_ncells=400, partition_ncells=partition_ncells, ensize_K=4, prep=False,
              indN_cluster=6)
    cfg = resolve_config(n, genes, **kw)
    d = _jax_draws(n, genes, cfg.ensize_K, cfg.reduced_ndim, kw["rN_seed"])
    ref = sharp_tpu.sharp(X, rM=d["R"], **kw)
    got = sharp_tpu_torch.sharp(
        X, rM=d["R"], device="cpu",
        testlog_probe=carry.testlog_probe_from_jax(d["testlog_perm"], d["R_probe"], n, genes, cfg.reduced_ndim, device="cpu"),
        shuffle_perm=carry.shuffle_perm_from_jax(d["shuffle_perm"], n),
        **kw,
    )
    T = len(tlarge.fold_sizes(n, partition_ncells))
    assert got.per_member_k.shape == (T, 4)
    np.testing.assert_array_equal(got.per_member_k, ref.per_member_k)
    np.testing.assert_array_equal(got.pred_clusters, ref.pred_clusters)
    assert (got.per_member_k == 6).all() == (T == 1)
