"""The batch axes of the selection, against the JAX package on the CPU.

The JAX package runs `opt_hclust` as one program vmapped over the members
of a block, over the folds of a group (wMetaC's meta problems included) and
over the blocks of a shape bucket (sMetaC). The port writes each axis out:
`sweep_scores_nested`, `select_cut`/`opt_hclust`, `wmetac` and `smetac`
take a leading lane, fold or block axis with per-lane `n_real`, `maxN` and
`N_cluster` tensors, and `core/large.fuse_blocks` batches the per-block
fuses. The same seeded numpy inputs go through `jax.vmap` of the JAX
function and through the port's batched function.

Tolerances: labels, cut indices, cluster counts, compaction tables and
wMetaC's votes are integers or exact ratios of integers and must be
identical. The median silhouette is held within 1e-6 absolute and CH within
1e-5 relative: both packages sum the same float32 terms in another order
(CH reaches ~1e3-1e4 and divides by a dispersion near 0, so a last-bit
difference of a correlation moves it ~1e-6 relative).

One torch thread, n_pad <= 256, p <= 16: the file takes well under a
minute alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharp_tpu.config import resolve_config
from sharp_tpu.core import large as jlarge
from sharp_tpu.core.wmetac import wmetac as j_wmetac
from sharp_tpu.ops import select as jsel
from sharp_tpu.ops import silhouette as jsil
from sharp_tpu_torch.config import resolve_config as t_resolve_config
from sharp_tpu_torch.core import large as tlarge
from sharp_tpu_torch.core.wmetac import wmetac as twmetac
from sharp_tpu_torch.core.fold import fold_program, fold_static_args
from sharp_tpu_torch.ops import linkage as tlink
from sharp_tpu_torch.ops import select as tsel
from sharp_tpu_torch.ops import silhouette as tsil
from tests.synth import make_tpm_like
from tests.test_large import _fake_fold_results
from torch_threads import one_torch_thread  # noqa: F401

N_PAD, P = 128, 16


def _replicas(seed, k=12, reps=6):
    """k clusters of `reps` near-duplicate points: the median silhouette
    saturates, so several cuts tie within SIL_TIE_EPS (sMetaC's shape)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(k, P)) * 3.0
    return (np.repeat(base, reps, axis=0) + rng.normal(size=(k * reps, P)) * 1e-3).astype(np.float32)


def _blobs(seed):
    """Overlapping blobs; a multiple of 3 also gets a few points on one
    pattern, far from the cloud in correlation."""
    rng = np.random.default_rng(100 + seed)
    k, scale, n = int(rng.integers(2, 9)), float(rng.uniform(0.3, 1.6)), int(rng.integers(60, 121))
    C = rng.normal(size=(k, P)) * scale
    x = (C[rng.integers(0, k, n)] + rng.normal(size=(n, P))).astype(np.float32)
    if seed % 3 == 0:
        pat = rng.normal(size=P)
        m = int(rng.integers(2, 6))
        x[:m] = pat * 5 + 0.3 * rng.normal(size=(m, P))
    return x


def _clean(seed, k=4, each=25):
    """k well-separated groups of `each` points."""
    rng = np.random.default_rng(seed)
    C = rng.normal(size=(k, P)) * 4.0
    return (np.repeat(C, each, axis=0) + rng.normal(size=(k * each, P))).astype(np.float32)


def _noise(seed, n):
    return np.random.default_rng(seed).normal(size=(n, P)).astype(np.float32)


def _lanes(xs):
    """Lanes of (N_PAD, P) features from the point sets xs, their masks
    and real counts."""
    mats = np.zeros((len(xs), N_PAD, P), np.float32)
    for lane, x in enumerate(xs):
        mats[lane, : len(x)] = x
    n_real = np.asarray([len(x) for x in xs], np.int32)
    masks = np.arange(N_PAD)[None, :] < n_real[:, None]
    return mats, masks, n_real


def _rule_lanes():
    """Six lanes for the rule chain: a near-tie lane (replicas), a
    height-gap lane (blobs 1: CH falls back to its first candidate and the
    dendrogram has a gap), a CH-fallback lane (blobs 39), a clean lane,
    pure noise, and a lane of 5 points."""
    return _lanes([_replicas(4), _blobs(1), _blobs(39), _clean(3), _noise(5, 110), _noise(6, 5)])


def _rules(res, n_real, sil_thre=0.35, eps=1e-4):
    """Which rule decided each lane of a JAX result: 'near', 'sil', 'ch' or 'gap'."""
    out = []
    for lane in range(len(n_real)):
        v = np.asarray(res.valid[lane])
        ms = np.where(v, np.asarray(res.msil[lane]), -np.inf)
        mx = ms.max()
        if mx > sil_thre:
            out.append("near" if (v & (ms >= mx - eps)).sum() > 1 else "sil")
            continue
        ch_oind = int(np.argmax(np.where(v, np.asarray(res.ch[lane]), -np.inf)))
        th, tv = (np.asarray(x) for x in tlink.real_heights_tail(torch.tensor(np.asarray(res.heights[lane])),
                                                                  int(n_real[lane])))
        flag = ((th[1:] - th[:-1]) > th[:-1]) & tv[1:]
        out.append("gap" if ch_oind == 0 and flag.any() else "ch")
    return out


def test_sweep_scores_nested_over_lanes_matches_jax():
    """The lane-batched nested sweep against the JAX package's nested sweep
    per lane (traced n_real and maxN) and against the port's own per-cut
    `sweep_scores`, which is held against the JAX package's `sweep_scores`
    (`silhouette_median` and `ch_index` per cut), on six lanes of distinct
    real counts. (Near-duplicate
    points are left out here: their within-cluster dispersion is a sum of
    1 - corr terms at float32's resolution, so CH is rounding noise in
    every implementation; `_rule_lanes` holds their selection.)"""
    mats, masks, n_real = _lanes([_blobs(1), _blobs(39), _clean(3), _noise(5, 110), _noise(6, 5), _blobs(13)])
    maxN = np.asarray([40, 30, 40, 12, 40, 40], np.int32)
    kw = dict(minN=2, ncand=39, nc_pad=48)
    mt, mk = torch.from_numpy(mats), torch.from_numpy(masks)
    D, D_real, feats = tsel.prep_distance(mt, mk, symmetric=False)
    link = tlink.ward_linkage(D)
    cuts = tlink.cutree_multi(link.merges, torch.from_numpy(n_real), mk, torch.from_numpy(maxN), **kw)
    msil, ch = tsil.sweep_scores_nested(
        D_real, feats, link.merges, cuts.labels, mk, torch.from_numpy(n_real), torch.from_numpy(maxN), **kw
    )
    assert msil.shape == ch.shape == (len(n_real), kw["ncand"])
    ks = torch.arange(kw["minN"], kw["minN"] + kw["ncand"])
    for lane in range(len(n_real)):
        valid = cuts.valid[lane].numpy()
        jm, jc = jsil.sweep_scores_nested(
            *(jnp.asarray(x[lane].numpy()) for x in (D_real, feats, link.merges, cuts.labels)),
            jnp.asarray(masks[lane]), jnp.asarray(n_real[lane]), jnp.asarray(maxN[lane]), **kw,
        )
        np.testing.assert_allclose(msil[lane].numpy()[valid], np.asarray(jm)[valid], atol=1e-6)
        np.testing.assert_allclose(ch[lane].numpy()[valid], np.asarray(jc)[valid], rtol=1e-5)
        pm, pc = tsil.sweep_scores(D_real[lane], feats[lane], cuts.labels[lane], ks, mk[lane], int(n_real[lane]),
                                   nc_pad=kw["nc_pad"])
        np.testing.assert_allclose(msil[lane].numpy()[valid], pm.numpy()[valid], atol=1e-6)
        np.testing.assert_allclose(ch[lane].numpy()[valid], pc.numpy()[valid], rtol=1e-5)
        # the port's unnested sweep against the JAX package's
        jpm, jpc = jsil.sweep_scores(
            *(jnp.asarray(x[lane].numpy()) for x in (D_real, feats, cuts.labels)), jnp.asarray(ks.numpy()),
            jnp.asarray(masks[lane]), jnp.asarray(n_real[lane]), nc_pad=kw["nc_pad"],
        )
        np.testing.assert_allclose(pm.numpy()[valid], np.asarray(jpm)[valid], atol=1e-6)
        np.testing.assert_allclose(pc.numpy()[valid], np.asarray(jpc)[valid], rtol=1e-5)


@pytest.mark.parametrize("fixed", [False, True], ids=["rule_chain", "N_cluster"])
def test_opt_hclust_over_lanes_matches_vmapped_jax(fixed):
    """`opt_hclust` over six lanes against `jax.vmap` of the JAX function
    with traced per-lane n_real, maxN and (fixed) N_cluster: labels, k and
    oind identical. The rule chain covers a near-tie lane, a CH-fallback
    lane and a height-gap lane."""
    mats, masks, n_real = _rule_lanes()
    maxN = np.asarray([40, 40, 30, 40, 20, 40], np.int32)
    kw = dict(symmetric=False, minN=2, ncand=39, nc_pad=48, sil_thre=0.35, height_Ntimes=2.0)
    args = (mats, masks, n_real, maxN)
    if fixed:
        N_cl = np.asarray([3, 5, 2, 4, 7, 3], np.int32)
        ref = jax.vmap(lambda m, k, n, x, c: jsel.opt_hclust(m, k, n, x, N_cluster=c, **kw))(
            *(jnp.asarray(a) for a in args + (N_cl,))
        )
        got = tsel.opt_hclust(*(torch.from_numpy(a) for a in args), N_cluster=torch.from_numpy(N_cl), **kw)
    else:
        ref = jax.vmap(lambda m, k, n, x: jsel.opt_hclust(m, k, n, x, **kw))(*(jnp.asarray(a) for a in args))
        got = tsel.opt_hclust(*(torch.from_numpy(a) for a in args), **kw)
        rules = _rules(ref, n_real)
        assert {"near", "ch", "gap"} <= set(rules), rules
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(ref.k))
    np.testing.assert_array_equal(got.oind.numpy(), np.asarray(ref.oind))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    # one lane alone gives that lane's answer
    one = tsel.opt_hclust(torch.from_numpy(mats[1]), torch.from_numpy(masks[1]), int(n_real[1]), int(maxN[1]),
                          N_cluster=int(N_cl[1]) if fixed else None, **kw)
    assert int(one.oind) == int(ref.oind[1])
    np.testing.assert_array_equal(one.labels.numpy(), np.asarray(ref.labels[1]))


def _member_labels(n, K, nc_pad, rng, clusters):
    """(N_PAD, K) member labellings of `clusters` true groups: each member
    splits one group in two and relabels in a random order."""
    y = rng.integers(0, clusters, n)
    lab = np.full((N_PAD, K), nc_pad - 1, np.int32)
    for k in range(K):
        yk = y.copy()
        t = rng.integers(0, clusters)
        idx = np.nonzero(yk == t)[0]
        yk[idx[: len(idx) // 2]] = clusters
        lab[:n, k] = rng.permutation(clusters + 1)[yk]
    return lab


def test_wmetac_over_folds_matches_vmapped_jax():
    """`wmetac` over three folds (one serial-Ward call of the three meta
    problems) against `jax.vmap` of the JAX function: finalC, n_meta, x0,
    tf, allC and overflow identical. Fold 0 is ordinary, fold 1 overflows
    the allc_pad budget (4 members x 20 clusters > 64), fold 2 takes the
    single-cluster fallback (R/wMetaC.R:147-161)."""
    K, nc_pad, allc_pad = 4, 24, 64
    rng = np.random.default_rng(0)
    n = np.asarray([120, 110, 60], np.int32)
    labels = np.stack([
        _member_labels(120, K, nc_pad, rng, 5),
        _member_labels(110, K, nc_pad, rng, 19),
        np.full((N_PAD, K), nc_pad - 1, np.int32),
    ])
    labels[2, :60] = 0
    labels[2, rng.choice(60, 6, replace=False), 1] = 1
    masks = np.arange(N_PAD)[None, :] < n[:, None]
    maxN = np.asarray([14, 14, 14], np.int32)
    kw = dict(K=K, nc_pad=nc_pad, allc_pad=allc_pad, meta_minN=2, meta_ncand=13)
    ref = jax.vmap(lambda lab, m, nr, mx: j_wmetac(lab, m, nr, mx, **kw))(
        *(jnp.asarray(a) for a in (labels, masks, n, maxN))
    )
    got = twmetac(*(torch.from_numpy(a) for a in (labels, masks, n, maxN)), **kw)
    assert list(np.asarray(ref.overflow)) == [False, True, False]
    assert int(np.asarray(ref.n_meta)[2]) == 2   # the fallback split the one cluster
    for field in ("finalC", "n_meta", "x0", "tf", "allC", "overflow"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(ref, field)), err_msg=field)


def test_fuse_blocks_matches_jax_and_the_fuse_folds_loop():
    """Nine blocks of four folds in one shape bucket (one `smetac` call of
    9 lanes here; the JAX package runs a group of 8 and a padded group of
    1) and a block of one fold, through the port's `fuse_blocks`, the JAX
    package's `fuse_blocks` and the port's `fuse_folds` block by block:
    labels identical."""
    rng = np.random.default_rng(5)
    cfg = resolve_config(40000, 1000, ensize_K=3, reduced_ndim=16, partition_ncells=500, forview=False)
    tcfg = t_resolve_config(40000, 1000, ensize_K=3, reduced_ndim=16, partition_ncells=500, forview=False)
    blocks = [_fake_fold_results(rng, T=4, nclust=6, nc_pad=cfg.nc_pad, p=16, n_fold=500) for _ in range(9)]
    blocks.append(_fake_fold_results(rng, T=1, nclust=6, nc_pad=cfg.nc_pad, p=16, n_fold=500))
    preps = [tlarge._prepare_block(frs, tcfg) for frs in blocks[:9]]
    keys = {(p.NC_pad, p.minN, p.ncand, p.meta_nc_pad) for p in preps}
    assert len(keys) == 1, keys
    got = tlarge.fuse_blocks(blocks, tcfg, device="cpu")
    ref = jlarge.fuse_blocks(blocks, cfg)
    loop = [tlarge.fuse_folds(frs, tcfg, device="cpu") for frs in blocks]
    for g, r, f in zip(got, ref, loop):
        np.testing.assert_array_equal(g.labels, r.labels)
        np.testing.assert_array_equal(g.labels, f.labels)
        assert g.n_final == r.n_final == f.n_final
        np.testing.assert_array_equal(g.counts, f.counts)


def _host_reads(G, K):
    """aten::_local_scalar_dense and aten::nonzero events of one CPU
    fold_program call over G folds of K members."""
    from torch.profiler import ProfilerActivity, profile

    genes, B = 200, 64
    X, _ = make_tpm_like(n_cells=150, n_genes=genes, n_types=4, seed=3)
    cfg = t_resolve_config(150, genes, rN_seed=1, ensize_K=K, reduced_ndim=8)
    sizes = [50, 48, 45][:G]
    Xg = torch.zeros(G, B, genes)
    for g, sz in enumerate(sizes):
        Xg[g, :sz] = torch.from_numpy(X[50 * g : 50 * g + sz])
    masks = torch.arange(B)[None, :] < torch.tensor(sizes)[:, None]
    R = torch.from_numpy(np.random.default_rng(0).normal(size=(genes, K * 8)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fold_program(Xg, masks, sizes, R, True, **fold_static_args(cfg))
    counts = {e.key: e.count for e in prof.key_averages()}
    return counts.get("aten::_local_scalar_dense", 0), counts.get("aten::nonzero", 0)


def test_fold_program_host_reads_do_not_grow_with_lanes():
    """The fold program reads the host a fixed number of times, whatever
    the number of lanes: the same at G*K = 4 (one fold of 4 members) and 12
    (three folds), and it calls no nonzero. (On the CPU the reads are
    F.one_hot's range checks, which a CUDA tensor skips.)"""
    reads4, nz4 = _host_reads(1, 4)
    reads12, nz12 = _host_reads(3, 4)
    assert reads4 == reads12
    assert nz4 == nz12 == 0
