"""The port's analysis layer, gethclust and RData reader against the JAX
package on the CPU: the same seeded numpy inputs through both.

Tolerances, and why:
- markers: dp, best cluster and AUROC are the same bits (integer rank and
  tie sums, the same float32 operations); z to rtol 1e-6 (the JAX package's
  compiled code multiplies by an approximate reciprocal square root where
  the port divides by the square root: last-bit differences); the fold
  change to rtol 1e-6 (the per-cluster mean is a float32 matrix product,
  summed in another order by XLA and by PyTorch). The selected genes and
  their expression rows are identical.
- gethclust: labels and the chosen cut identical; merge heights to rtol
  1e-6 (the JAX function's full-argmin loop compiles its Lance-Williams
  update with other rounding than the port's one-operation-at-a-time
  loop), the median silhouette to atol 1e-6 and CH to rtol 1e-4 (the
  sweep's float32 matrix products sum in another order; CH divides by a
  within-cluster dispersion of 1 - corr terms near 0, which turns a
  last-bit difference into ~1e-5 relative), as for get_opt_hclust in
  tests/test_torch_ops.py.
- embedding: the joint P to rtol 1e-4 (exp and log of the two frameworks
  differ in the last bits, and the bisection on each row's precision
  carries that into P); the layout after 10 iterations from the same start
  to 1e-2 of its largest coordinate. The early-exaggerated steps grow the
  layout from 1e-4 to tens and amplify every rounding difference (the port
  also forms (diag(rowsum) - PQ) @ Y as rowsum * Y - PQ @ Y): measured
  2.5e-4 here and 1.8e-3 between the H100 and the CPU, while a constant of
  the update off by 1% (the gradient's 4, a momentum, the exaggeration)
  moves the layout by about 0.4 of its largest coordinate.
"""

import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharp_tpu.analysis import embed as jembed
from sharp_tpu.analysis import markers as jmark
from sharp_tpu.analysis import percluster as jperc
from sharp_tpu.io import rdata as jrdata
from sharp_tpu.ops import select as jsel
from sharp_tpu_torch import carry
from sharp_tpu_torch.analysis import embed as tembed
from sharp_tpu_torch.analysis import markers as tmark
from sharp_tpu_torch.analysis import percluster as tperc
from sharp_tpu_torch.io import rdata as trdata
from sharp_tpu_torch.ops import select as tsel
from sharp_tpu_torch.types import SharpResult
from torch_threads import one_torch_thread  # noqa: F401

# the layout after 10 t-SNE iterations, relative to its largest coordinate
TSNE_TOL = 1e-2


def _planted(n, D, C, seed, zeros=0.4):
    """Log-normal expression with a share of exact zeros outside the 5
    planted markers per cluster (columns 20..20 + 5C); labels 1..C."""
    rng = np.random.default_rng(seed)
    y = rng.integers(1, C + 1, n)
    X = rng.lognormal(0.5, 0.5, size=(n, D)).astype(np.float32)
    drop = rng.random((n, D)) < zeros
    drop[:, 20 : 20 + 5 * C] = False
    X[drop] = 0.0
    for c in range(1, C + 1):
        X[np.ix_(y == c, np.arange((c - 1) * 5, c * 5) + 20)] *= 30.0
    return X, y


def _same_markers(got, ref):
    for k in ("gene", "gene_index", "cluster", "sparsity", "auc"):
        np.testing.assert_array_equal(got.mginfo[k], ref.mginfo[k])
        np.testing.assert_array_equal(got.gallinfo[k], ref.gallinfo[k])
    np.testing.assert_allclose(got.gallinfo["fold_change"], ref.gallinfo["fold_change"], rtol=1e-6)
    # p = 2 sf(|z|): a relative error e of z moves p by about z^2 e
    np.testing.assert_allclose(got.gallinfo["pvalue"], ref.gallinfo["pvalue"], rtol=1e-4, atol=1e-300)
    np.testing.assert_array_equal(got.mat, ref.mat)
    assert got.adauc == ref.adauc
    np.testing.assert_array_equal(got.label, ref.label)


def test_holm_matches_r_semantics():
    p = np.array([0.01, 0.04, 0.03, 0.005])
    # R: p.adjust(c(.01,.04,.03,.005), "holm") -> 0.03 0.06 0.06 0.02
    np.testing.assert_allclose(tmark._holm(p), [0.03, 0.06, 0.06, 0.02], atol=1e-12)
    q = np.random.default_rng(0).random(50) ** 3
    np.testing.assert_array_equal(tmark._holm(q), jmark._holm(q))


def test_percluster_split_matches_the_jax_package():
    X = np.arange(60, dtype=np.float32).reshape(20, 3)
    y = np.random.default_rng(1).integers(1, 5, 20)
    res = SharpResult(pred_clusters=y, N_pred_cluster=4, unique_pred_clusters=[], distr_pred_clusters={})
    for got in (tperc.get_percluster_exp(X, y), tperc.get_percluster_exp([X[:7], X[7:]], res)):
        ref = jperc.get_percluster_exp(X, y)
        assert list(got) == list(ref)
        for c in ref:
            np.testing.assert_array_equal(got[c], ref[c])
    with pytest.raises(ValueError, match="align"):
        tperc.get_percluster_exp(X[:5], y)


@pytest.mark.parametrize("ng", [1, 2, 4])
def test_chunk_stats_match_the_jax_package(ng):
    X, y = _planted(240, 96, 4, seed=ng)
    X[:, 3] = 0.0          # an all-zero gene: one tie group of every cell
    X[:, 4] = X[0, 4]      # a constant gene
    enc = y - 1
    oh = np.eye(4, dtype=np.float32)[enc]
    counts = np.bincount(enc).astype(np.float32)
    ref = jmark._gene_chunk_stats(jnp.asarray(X), jnp.asarray(oh), jnp.asarray(counts), C=4, ng=ng)
    got = tmark._gene_chunk_stats(torch.from_numpy(X), torch.from_numpy(oh), torch.from_numpy(counts),
                                  C=4, ng=ng)
    dp, best, auc, z, fc = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(got[0].numpy(), dp)
    np.testing.assert_array_equal(got[1].numpy(), best)
    np.testing.assert_array_equal(got[2].numpy(), auc)
    np.testing.assert_allclose(got[3].numpy(), z, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[4].numpy(), fc, rtol=1e-6)
    assert got[1].dtype == torch.int32


def test_marker_genes_match_the_jax_package_full_and_blocked():
    X, y = _planted(300, 400, 3, seed=5)
    names = np.array([f"G{i}" for i in range(400)])
    ref = jmark.get_marker_genes(X, y, gene_names=names, chunk=128)
    full = tmark.get_marker_genes(X, y, gene_names=names, chunk=128, device="cpu")
    res = SharpResult(pred_clusters=y, N_pred_cluster=3, unique_pred_clusters=[], distr_pred_clusters={})
    blocked = tmark.get_marker_genes([X[:110], X[110:200], X[200:]], res, gene_names=names,
                                     chunk=128, device="cpu")
    assert full.n_markers >= 3
    for got in (full, blocked):
        _same_markers(got, ref)
    found = {int(c): set(full.mginfo["gene_index"][full.mginfo["cluster"] == c]) for c in (1, 2, 3)}
    for c in (1, 2, 3):
        assert len(found[c] & set(range((c - 1) * 5 + 20, c * 5 + 20))) >= 3


def test_marker_genes_unlimited2_matches_the_jax_package(tmp_path):
    X, y = _planted(150, 90, 3, seed=3)
    split = [X[:, :40], X[:, 40:70], X[:, 70:]]
    d = tmp_path / "gblocks"
    d.mkdir()
    for i, b in enumerate(split):
        np.savez(d / f"genes_{i}.npz", X=b)
    for form in (split, str(d)):
        for ng in (None, 1):
            ref = jmark.get_marker_genes_unlimited2(form, y, ng=ng, chunk=32)
            got = tmark.get_marker_genes_unlimited2(form, y, ng=ng, chunk=32, device="cpu")
            _same_markers(got, ref)
    # ng=1 is the base candidate rule: the same genes as get_marker_genes
    # at unlimited2's thresholds
    one = tmark.get_marker_genes(X, y, theta=1e-5, auc_thre=0.85, p_thre=0.05, device="cpu")
    np.testing.assert_array_equal(one.mginfo["gene_index"], got.mginfo["gene_index"])
    with pytest.raises(ValueError, match="share the cell axis"):
        tmark.get_marker_genes_unlimited2([X[:100, :40]], y, device="cpu")


@pytest.mark.parametrize("n", [100, 300])
def test_gethclust_matches_the_jax_package(n):
    """Mirrors tests/test_select.py::test_public_get_opt_hclust_and_gethclust."""
    from scipy.spatial.distance import pdist, squareform

    from sharp_tpu_torch.analysis.ari import ari

    rng = np.random.default_rng(12 + n)
    y = rng.integers(0, 4, n)
    X = (4.0 * np.eye(4)[y] @ rng.normal(size=(4, 12)) + 0.2 * rng.normal(size=(n, 12))).astype(np.float32)
    d = squareform(pdist(X, metric="correlation")).astype(np.float32)
    ref = jsel.gethclust(d, X)
    got = tsel.gethclust(d, X, device="cpu")
    np.testing.assert_array_equal(got["f"], ref["f"])
    assert got["oind"] == ref["oind"]
    np.testing.assert_allclose(got["height"], ref["height"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["msil"], ref["msil"], atol=1e-6)
    np.testing.assert_allclose(got["CHind"], ref["CHind"], rtol=1e-4)
    assert got["maxsil"] == pytest.approx(ref["maxsil"], abs=1e-6)
    assert ari(y, got["f"]) == pytest.approx(1.0)
    assert got["f"].min() == 1 and len(got["height"]) == n - 1


def _view_features(n, C, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, C, n)
    x0 = np.eye(C, dtype=np.float32)[y] + 0.05 * rng.random((n, C)).astype(np.float32)
    viE = (y[:, None] * 2.0 + rng.normal(size=(n, 8))).astype(np.float32)
    return y, x0, viE


def test_embedding_p_and_first_steps_match_the_jax_package():
    y, x0, viE = _view_features(300, 3, seed=3)
    X, idx = tembed.embedding_input((x0, viE))
    np.testing.assert_array_equal(idx, np.arange(300))
    n = X.shape[0]
    Xj = jnp.asarray(X)
    sq = jnp.sum(Xj * Xj, axis=1)
    D2 = jnp.maximum(sq[:, None] + sq[None, :] - 2.0 * (Xj @ Xj.T), 0.0)
    Pc = np.asarray(jembed._binary_search_sigmas(D2, 30.0))
    P_ref = np.maximum((Pc + Pc.T) / (2.0 * n), 1e-12)
    P = tembed._joint_p(torch.from_numpy(X), 30.0).numpy()
    np.testing.assert_allclose(P, P_ref, rtol=1e-4, atol=1e-12)

    key = jax.random.PRNGKey(10)
    Y0 = carry.tsne_layout_from_jax(np.asarray(1e-4 * jax.random.normal(key, (n, 2))), n, device="cpu")
    ref = np.asarray(jembed._tsne_exact(Xj, key, n_iter=10))
    res = SharpResult(pred_clusters=y + 1, N_pred_cluster=3, unique_pred_clusters=[],
                      distr_pred_clusters={}, viE=viE, x0=x0)
    got, idx = tembed.visualization_embedding(res, n_iter=10, Y0=Y0, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=0, atol=TSNE_TOL * np.abs(ref).max())
    with pytest.raises(ValueError, match="Y0"):
        tembed.visualization_embedding(res, n_iter=1, Y0=np.zeros((5, 2)), device="cpu")
    with pytest.raises(ValueError, match="Y0"):
        carry.tsne_layout_from_jax(np.zeros((5, 2)), n, device="cpu")


def test_embedding_separates_clusters():
    """Mirrors tests/test_analysis.py::test_embedding_separates_clusters, with
    the port's own start layout and a subsample."""
    y, x0, viE = _view_features(160, 3, seed=3)
    res = SharpResult(pred_clusters=y + 1, N_pred_cluster=3, unique_pred_clusters=[],
                      distr_pred_clusters={}, viE=viE, x0=x0)
    emb, idx = tembed.visualization_embedding(res, n_iter=300, max_cells=120, device="cpu")
    assert emb.shape == (len(idx), 2) and np.all(np.isfinite(emb))
    lab = y[idx]
    cent = np.stack([emb[lab == c].mean(0) for c in range(3)])
    within = np.mean([np.mean(np.linalg.norm(emb[lab == c] - cent[c], axis=1)) for c in range(3)])
    between = np.mean([np.linalg.norm(cent[a] - cent[b]) for a in range(3) for b in range(a + 1, 3)])
    assert between > 3 * within
    with pytest.raises(ValueError, match="forview"):
        tembed.visualization_embedding((None, None), device="cpu")


# --- R serialization streams, written by hand (XDR, format version 2/3) ---

def _u32(v):
    return struct.pack(">I", v)


def _charsxp(s):
    b = s.encode()
    return _u32(0x00040009) + struct.pack(">i", len(b)) + b


def _strsxp(items, attrs=b""):
    out = _u32(16 | (0x200 if attrs else 0)) + _u32(len(items))
    for s in items:
        out += _u32(9) + struct.pack(">i", -1) if s is None else _charsxp(s)  # NA_STRING
    return out + attrs


def _pairlist(entries):
    """Attribute pairlist of (tag, encoded value); a tag given as an int is
    a back-reference (REFSXP) to the symbol of that index."""
    out = b""
    for tag, val in entries:
        out += _u32(2 | 0x400)
        out += _u32((tag << 8) | 0xFF) if isinstance(tag, int) else _u32(1) + _charsxp(tag)
        out += val
    return out + _u32(254)


def _realsxp(vals, attrs=b""):
    return _u32(14 | (0x200 if attrs else 0)) + _u32(len(vals)) + struct.pack(f">{len(vals)}d", *vals) + attrs


def _intsxp(vals, attrs=b""):
    return _u32(13 | (0x200 if attrs else 0)) + _u32(len(vals)) + struct.pack(f">{len(vals)}i", *vals) + attrs


def _factor(codes, levels, refs=False):
    return _intsxp(codes, _pairlist([
        (1 if refs else "levels", _strsxp(levels)),
        (2 if refs else "class", _strsxp(["factor"])),
    ]))


def _header(version):
    out = b"X\n" + _u32(version) + _u32(0x040201) + _u32(0x020300)
    if version >= 3:
        out += _u32(5) + b"UTF-8"
    return out


def _objects(refs=True):
    """Encoded test objects; with `refs` (a stream of one object) the list's
    second factor names its attribute symbols by reference."""
    matrix = _realsxp([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], _pairlist([
        ("dim", _intsxp([2, 3])),
        ("dimnames", _u32(19) + _u32(2) + _strsxp(["r1", "r2"]) + _strsxp(["a", "b", "c"])),
    ]))
    # a named list of two factors: the second may name its attribute
    # symbols by reference (symbols 1 and 2 of the stream, "levels" and
    # "class")
    named = _u32(19 | 0x200) + _u32(2) + _factor([1, 2, 1], ["lo", "hi"]) + \
        _factor([2, -2147483648], ["x", "y"], refs=refs) + _pairlist([("names", _strsxp(["f", "g"]))])
    return {
        "vector": _realsxp([0.5, -1.25, 1e300]),
        "factor": _factor([2, 1, 3, 2], ["alpha", "beta", "delta"]),
        "matrix": matrix,
        "list": named,
        "ints": _intsxp([3, -7, 0]),
        "strings": _strsxp(["a", None, "ccc"]),
    }


def _plain(obj, rd):
    """An object of either reader as plain Python, to compare them."""
    if isinstance(obj, rd.RFactor):
        return ("factor", obj.codes.tolist(), obj.levels, obj.as_strings().tolist())
    if isinstance(obj, rd.RMatrix):
        return ("matrix", obj.values.tolist(), obj.rownames.tolist(), obj.colnames.tolist())
    if isinstance(obj, np.ndarray):
        return ("array", str(obj.dtype), obj.tolist())
    if isinstance(obj, dict):
        return {k: _plain(v, rd) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v, rd) for v in obj]
    return obj


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("version", [2, 3])
def test_rdata_reader_matches_the_jax_package(tmp_path, compress, version):
    opener = gzip.open if compress else open
    for name, body in _objects().items():
        path = tmp_path / f"{name}.rds"
        with opener(path, "wb") as fh:
            fh.write(_header(version) + body)
        got, ref = trdata.read_rds(str(path)), jrdata.read_rds(str(path))
        assert _plain(got, trdata) == _plain(ref, jrdata)
    objs = _objects(refs=False)
    path = tmp_path / "ws.RData"
    with opener(path, "wb") as fh:
        fh.write(b"RDX%d\n" % version + _header(version) + _pairlist(list(objs.items())))
    got, ref = trdata.read_rdata(str(path)), jrdata.read_rdata(str(path))
    assert list(got) == list(objs)
    assert _plain(got, trdata) == _plain(ref, jrdata)
    assert got["factor"].as_strings().tolist() == ["beta", "alpha", "delta", "beta"]
    assert got["matrix"].values.tolist() == [[1.0, 3.0, 5.0], [2.0, 4.0, 6.0]]
    assert got["list"]["g"].as_strings().tolist() == ["y", None]
    bad = tmp_path / "bad.RData"
    bad.write_bytes(b"RDA2\n" + _header(version))
    with pytest.raises(ValueError, match="not an RData file"):
        trdata.read_rdata(str(bad))
