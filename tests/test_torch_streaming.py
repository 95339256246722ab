"""The port's streaming path (`sharp_unlimited`, the SBLK codec, the block
store and the sparse feed) against the JAX package, on the CPU.

Mirrors tests/test_streaming.py and tests/test_native_io.py. Both packages
get the same numpy-made ensemble RP matrix, patched into their streaming
modules (each imports `ensemble_rp_matrix` by name): labels must be
identical. The wire and the on-device densify are integer bookkeeping and
copies of the same float32 values: identical too.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sharp_tpu.parallel.streaming as jstream
from sharp_tpu.io import native as jnative
from sharp_tpu.io import sparse as jsparse
from sharp_tpu.io.blocks import save_blocks as j_save_blocks
from sharp_tpu_torch import sharp_unlimited
from sharp_tpu_torch.analysis.ari import ari
from sharp_tpu_torch.config import resolve_config
from sharp_tpu_torch.io import native, sparse
from sharp_tpu_torch.io.blocks import BlockStore, save_blocks
from sharp_tpu_torch.parallel import streaming
from tests.synth import make_tpm_like
from tests.torch_mh_worker import shared_rp, ternary
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(rN_seed=19, ensize_K=4, partition_ncells=250, base_ncells=300)


@pytest.fixture(scope="module")
def blocked_data():
    X, y = make_tpm_like(n_cells=1000, n_genes=600, n_types=5, seed=41)
    return X, y, [X[:400], X[400:700], X[700:]]


@pytest.fixture
def same_rp(monkeypatch):
    """One numpy RP matrix for both packages' streaming modules (the one the
    two-process workers use too)."""
    monkeypatch.setattr(
        jstream, "ensemble_rp_matrix",
        lambda key, K, m, p, dtype=jnp.float32: jnp.asarray(shared_rp(K, m, p), dtype),
    )
    monkeypatch.setattr(
        streaming, "ensemble_rp_matrix",
        lambda seed, K, m, p, dtype=torch.float32, device="cpu": torch.from_numpy(shared_rp(K, m, p)).to(device, dtype),
    )


# --- codec and block store ----------------------------------------------------


def _random_sparse(n, g, density, seed, ints=False):
    rng = np.random.default_rng(seed)
    return sp.random(
        n, g, density=density, format="csr", random_state=seed,
        data_rvs=lambda k: rng.integers(1, 500, k).astype(np.float64) if ints else rng.lognormal(1, 1, k),
    )


@pytest.mark.parametrize("ints", [False, True])
def test_sblk_files_are_byte_compatible(tmp_path, ints):
    """Files written by either package read the same in the other, and the
    two writers produce the same bytes."""
    M = _random_sparse(123, 456, 0.05, seed=0, ints=ints)
    ours, theirs = str(tmp_path / "ours.sblk"), str(tmp_path / "theirs.sblk")
    native.write_sblk(ours, M)
    jnative.write_sblk(theirs, M)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    ref = np.asarray(M.todense(), np.float32)
    for path in (ours, theirs):
        assert native.read_header(path) == jnative.read_header(path) == (123, 456, M.nnz, int(ints))
        np.testing.assert_array_equal(native.densify(path), jnative._py_densify(path))
        np.testing.assert_allclose(native.densify(path), ref, rtol=1e-6)
    with open(str(tmp_path / "bad.sblk"), "wb") as fh:
        fh.write(b"NOTSBLK" + bytes(40))
    # the codec's error code for a bad magic, as the JAX package's; the
    # plain parser's message
    with pytest.raises(IOError, match="rc=5"):
        native.read_header(str(tmp_path / "bad.sblk"))
    with pytest.raises(IOError, match="rc=5"):
        jnative.read_header(str(tmp_path / "bad.sblk"))
    with pytest.raises(IOError, match="not an SBLK"):
        native._py_read_header(str(tmp_path / "bad.sblk"))


def _codec_case(tmp_path, ints):
    """An SBLK file of 211 x 300 with empty rows (first, last and in the
    middle) and a full row, float32 or uint16 values."""
    M = _random_sparse(211, 300, 0.1, seed=5, ints=ints).tolil()
    M[[0, 50, 51, 210]] = 0
    M[100] = np.arange(1, 301)
    path = str(tmp_path / f"codec_{int(ints)}.sblk")
    native.write_sblk(path, M.tocsr())
    return path


@pytest.mark.parametrize("ints", [False, True])
@pytest.mark.parametrize("n_threads", [1, 3, 0])
def test_native_densify_matches_jax_and_the_plain_version(tmp_path, ints, n_threads):
    """The port's codec (built with g++ at first use) densifies bit for bit
    as the JAX package's codec and as the numpy plain version, at any
    thread count (0: all cores)."""
    assert native.get_lib() is not None
    path = _codec_case(tmp_path, ints)
    assert native.read_header(path)[3] == int(ints)
    got = native.densify(path, n_threads)
    assert got.dtype == np.float32 and got.shape == (211, 300)
    np.testing.assert_array_equal(got, native._py_densify(path))
    np.testing.assert_array_equal(got, jnative.densify(path, n_threads))
    assert not got[[0, 50, 51, 210]].any() and (got[100] == np.arange(1, 301)).all()


def test_native_codec_errors(tmp_path):
    """A corrupt header raises IOError with the codec's code (5 a bad magic,
    6 a truncated payload, 7 an indptr that does not end at nnz), as in the
    JAX package."""
    path = _codec_case(tmp_path, False)
    raw = open(path, "rb").read()
    n, g, nnz, _ = native.read_header(path)
    cases = {
        5: b"SBLK2\0\0\0" + raw[8:],
        6: raw[: len(raw) - 8],
        7: raw[: 40 + 8 * n] + np.int64(nnz - 1).tobytes() + raw[40 + 8 * (n + 1):],
    }
    for rc, data in cases.items():
        bad = str(tmp_path / f"bad{rc}.sblk")
        open(bad, "wb").write(data)
        for densify in (native.densify, jnative.densify):
            with pytest.raises(IOError, match=f"rc={rc}"):
                densify(bad)


def test_native_build(monkeypatch, tmp_path):
    """The codec is built into SHARP_TPU_NATIVE_CACHE, keyed on its source;
    without g++ there is no codec and densify takes the plain version; a
    build that fails with g++ present raises."""
    path = _codec_case(tmp_path, True)
    cache = tmp_path / "cache"
    monkeypatch.setenv("SHARP_TPU_NATIVE_CACHE", str(cache))
    lib = native._build_lib()
    assert lib is not None and [p.name for p in cache.iterdir()] == [os.path.basename(lib._name)]
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.get_lib() is None
    np.testing.assert_array_equal(native.densify(path), native._py_densify(path))
    monkeypatch.undo()
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setenv("SHARP_TPU_NATIVE_CACHE", str(cache))
    monkeypatch.setattr(native, "SRC", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._build_lib()


def test_blockstore_loads_sblk_through_the_codec(tmp_path, monkeypatch):
    """BlockStore.load reads an SBLK file through the codec's densify."""
    path = _codec_case(tmp_path, False)
    calls = []
    real = native.densify
    monkeypatch.setattr(native, "densify", lambda p, n_threads=0: calls.append(p) or real(p, n_threads))
    np.testing.assert_array_equal(BlockStore.load(path), native._py_densify(path))
    assert calls == [path]


def test_blockstore_roundtrip(tmp_path, blocked_data):
    X, y, blocks = blocked_data
    d = str(tmp_path / "blocks")
    save_blocks(d, blocks)
    store = BlockStore(d)
    assert store.shape_info() == {"n_cells": 1000, "n_genes": 600, "n_blocks": 3}
    files = store.files()
    assert [os.path.basename(f) for f in files] == [f"block_{i:05d}.npz" for i in range(3)]
    for f, b in zip(files, blocks):
        np.testing.assert_array_equal(BlockStore.load(f), b.astype(np.float32))
    s = str(tmp_path / "sblk")
    save_blocks(s, [sp.csr_matrix(b) for b in blocks], fmt="sblk")
    for f, b in zip(BlockStore(s).files(), blocks):
        np.testing.assert_array_equal(BlockStore.load(f), b.astype(np.float32))


def test_blockstore_mixed_naming_rejected(tmp_path):
    d = tmp_path / "mixed"
    d.mkdir()
    np.savez(d / "block_1.npz", X=np.zeros((2, 3), np.float32))
    np.savez(d / "extra.npz", X=np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="mixes"):
        BlockStore(str(d)).files()


# --- the wire and the densify -------------------------------------------------


def test_sparse_block_from_scipy_shares_what_it_need_not_convert():
    """A canonical matrix's int32 ids and float32 values go into the block
    uncopied (the prefetch thread copies nothing); float64 values are
    converted. Both blocks densify to the matrix."""
    X = _random_sparse(60, 40, 0.2, 3).astype(np.float32)
    sb = sparse.SparseBlock.from_scipy(X)
    assert np.shares_memory(sb.indices, X.indices) and np.shares_memory(sb.data, X.data)
    X64 = X.astype(np.float64)
    sb64 = sparse.SparseBlock.from_scipy(X64)
    assert sb64.data.dtype == np.float32 and not np.shares_memory(sb64.data, X64.data)
    for block in (sb, sb64):
        np.testing.assert_array_equal(block.densify(), X.toarray())


def test_sparse_block_roundtrip(tmp_path, blocked_data):
    _, _, blocks = blocked_data
    b = blocks[1]
    path = str(tmp_path / "b.sblk")
    native.write_sblk(path, b)
    sb = sparse.SparseBlock.from_sblk(path)
    np.testing.assert_allclose(sb.densify(), b, rtol=1e-6)
    sb2 = sparse.SparseBlock.from_scipy(sp.csr_matrix(b))
    np.testing.assert_array_equal(sb2.densify(), sb.densify())
    jb = jsparse.SparseBlock.from_sblk(path)
    for a, c in zip(sb, jb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def _wire_case():
    """A block with ragged rows, empty rows (also in the middle), a fat
    row and an empty fold, cut into four folds."""
    rng = np.random.default_rng(3)
    X = rng.lognormal(1, 1, size=(300, 200)).astype(np.float32)
    X[rng.uniform(size=X.shape) < 0.8] = 0.0
    X[[5, 6, 7, 130]] = 0.0
    X[131] = rng.lognormal(1, 1, 200)
    X[250:280] = 0.0
    return X, [0, 120, 240, 250], [120, 120, 10, 30], 128


def _which_side_moved(got, ref, raw):
    """Each side's log2(1 + x) against numpy's float64 log2(1 + x) of the
    same densified values: how many values are more than 2 float32 ulps off,
    and the largest error in ulps."""
    exact = np.log2(1.0 + raw.astype(np.float64))
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    out = []
    for name, side in (("the port (torch)", got), ("the JAX package (XLA)", ref)):
        err = np.abs(side.astype(np.float64) - exact) / ulp
        far = np.nonzero(err > 2)
        out.append(f"{name}: {far[0].size} of {err.size} values more than 2 ulps from float64, "
                   f"the largest {err.max():.1f} ulps")
        worst = np.unravel_index(np.argmax(err), err.shape)
        out[-1] += f" (x={raw[worst]!r}: {side[worst]!r} against {exact[worst]!r})"
        if far[0].size:
            out[-1] += (f", in folds {sorted(set(far[0].tolist()))}, rows {far[1].min()}-{far[1].max()}, "
                        f"genes {far[2].min()}-{far[2].max()}")
    return "; ".join(out)


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_fold_triplets_and_densify_match_jax(wire):
    X, starts, sizes, block_pad = _wire_case()
    sbj = jsparse.SparseBlock.from_scipy(sp.csr_matrix(X))
    sbt = sparse.SparseBlock.from_scipy(sp.csr_matrix(X))
    budget = sparse.nnz_pad(
        max(int(sbt.indptr[s + z] - sbt.indptr[s]) for s, z in zip(starts, sizes)), step=1024
    )
    assert budget == jsparse.nnz_pad(
        max(int(sbj.indptr[s + z] - sbj.indptr[s]) for s, z in zip(starts, sizes)), step=1024
    )
    jc, jcol, jv = jsparse.fold_triplets(sbj, starts, sizes, block_pad, budget, wire_dtype=wire)
    c, col, v = sparse.fold_triplets(sbt, starts, sizes, block_pad, budget, wire_dtype=wire)
    np.testing.assert_array_equal(c.numpy(), jc)
    assert col.dtype == torch.int16
    np.testing.assert_array_equal(col.numpy().view(np.uint16), jcol)
    np.testing.assert_array_equal(v.float().numpy(), np.asarray(jv, np.float32))
    for log2p1 in (False, True):
        ref = np.asarray(jsparse.densify_folds(
            jc, jcol, jv, block_pad=block_pad, genes=200, log2p1=log2p1
        ))
        got = sparse.densify_folds(c, col, v, block_pad=block_pad, genes=200, log2p1=log2p1)
        if log2p1:
            # the same float32 log2 of the same values, in XLA and in torch;
            # on a mismatch the message says which side left numpy's float64
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                       err_msg=_which_side_moved(got.numpy(), ref, raw))
            np.testing.assert_array_equal(got.numpy() == 0, ref == 0)
        else:
            np.testing.assert_array_equal(got.numpy(), ref)
            raw = ref
    if wire == "float32":
        dense = sparse.densify_folds(c, col, v, block_pad=block_pad, genes=200).numpy()
        for gi, (s, z) in enumerate(zip(starts, sizes)):
            np.testing.assert_array_equal(dense[gi, :z], X[s : s + z])
            assert not dense[gi, z:].any()


# a fresh process: the wire case's log2(1 + x) through the sparse feed, with
# every call of torch.log2 recorded
_FIRST_LOG2 = """
import json
import sys
import numpy as np
import scipy.sparse as sp
import torch

sys.path.insert(0, sys.argv[1])
calls = []
real = torch.log2


def spy(x, *a, **k):
    calls.append(x.numel())
    return real(x, *a, **k)


torch.log2 = spy
from sharp_tpu_torch.io import sparse

rng = np.random.default_rng(3)
X = rng.lognormal(1, 1, size=(300, 200)).astype(np.float32)
X[rng.uniform(size=X.shape) < 0.8] = 0.0
sb = sparse.SparseBlock.from_scipy(sp.csr_matrix(X))
c, col, v = sparse.fold_triplets(sb, [0, 120], [120, 120], 128, sparse.nnz_pad(int(sb.indptr[240]), step=1024))
got = sparse.densify_folds(c, col, v, block_pad=128, genes=200, log2p1=True).numpy()
raw = sparse.densify_folds(c, col, v, block_pad=128, genes=200).numpy()
s = (np.float32(1.0) + raw).astype(np.float64)
exact = np.log2(s)
ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
err = np.abs(got - exact) / np.maximum(ulp, 1e-45)
print(json.dumps({"calls": calls, "far": int((err > 1).sum()), "worst": float(err.max())}))
"""


def test_first_log2_of_a_process_runs_on_one_thread():
    """The sparse feed's log2(1 + x) in a fresh process: the process's first
    torch.log2 is on one element, on the calling thread, before the wire's
    (MKL's log2 over torch's threads could return one thread's chunk up to
    ~890 ulps off on a process's first parallel call); every value is
    within 1 ulp of float64's log2 of the same float32 sum 1 + x. The
    helper is the same function as torch.log2(1.0 + x)."""
    import json
    import subprocess
    import sys

    from sharp_tpu_torch.ops import rp

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = json.loads(subprocess.run([sys.executable, "-c", _FIRST_LOG2, root], capture_output=True,
                                    text=True, check=True, timeout=120).stdout)
    assert out["calls"][0] == 1 and len(out["calls"]) == 2 and out["calls"][1] > 2048, out
    assert out["far"] == 0, out
    x = torch.from_numpy(np.random.default_rng(5).lognormal(1, 1, 5000).astype(np.float32))
    assert torch.equal(rp.log2p1(x), torch.log2(1.0 + x))


def test_wire_edges():
    """int32 columns past 65536 genes; refilled staging buffers (counts
    zeroed, stale entries past nnz dropped); the budget check."""
    G = 70000
    X = sp.csr_matrix(
        (np.asarray([1.5, 2.5], np.float32), np.asarray([3, 69999], np.int32),
         np.asarray([0, 1, 2], np.int64)), shape=(2, G),
    )
    sb = sparse.SparseBlock.from_scipy(X)
    counts, cols, vals = sparse.fold_triplets(sb, [0], [2], 8, sparse.nnz_pad(2, step=8))
    assert cols.dtype == torch.int32
    dense = sparse.densify_folds(counts, cols, vals, block_pad=8, genes=G)
    assert dense[0, 0, 3] == 1.5 and dense[0, 1, 69999] == 2.5 and float(dense.sum()) == 4.0

    Y = np.zeros((6, 50), np.float32)
    Y[0, [1, 2, 3]] = 1.0
    Y[3, [4, 5]] = 2.0
    Y[5, 49] = 3.0
    sb = sparse.SparseBlock.from_scipy(sp.csr_matrix(Y))
    buf = sparse.wire_buffers(2, 8, 16, 50)
    buf[1].fill_(7)
    buf[2].fill_(9.0)
    out = sparse.fold_triplets(sb, [0, 3], [3, 3], 8, 16, out=buf)
    dense = sparse.densify_folds(*out, block_pad=8, genes=50)
    np.testing.assert_array_equal(dense[0, :3].numpy(), Y[:3])
    np.testing.assert_array_equal(dense[1, :3].numpy(), Y[3:])
    assert not dense[:, 3:].any()
    with pytest.raises(ValueError, match="budget"):
        sparse.fold_triplets(sb, [0], [6], 8, 4)


# --- sharp_unlimited against the JAX package ----------------------------------


def test_unlimited_list_input_matches_jax(blocked_data, same_rp):
    X, y, blocks = blocked_data
    ref = jstream.sharp_unlimited(blocks, **KW)
    res = sharp_unlimited(blocks, device="cpu", **KW)
    np.testing.assert_array_equal(res.pred_clusters, ref.pred_clusters)
    assert res.distr_pred_clusters == ref.distr_pred_clusters
    assert res.paras == ref.paras
    assert ari(y, res.pred_clusters) >= 0.85
    sizes = [res.distr_pred_clusters[c] for c in sorted(res.distr_pred_clusters)]
    assert sizes[0] == max(sizes)


def test_unlimited_sblk_directory_and_sparse_feed_match_jax(tmp_path, blocked_data, same_rp):
    """An SBLK directory through the sparse feed and through the host
    densify, against the JAX package's sparse feed; fuse_batch 1 and 8."""
    X, y, blocks = blocked_data
    d = str(tmp_path / "sblk")
    save_blocks(d, blocks, fmt="sblk")
    kw = dict(KW, resume=False)
    ref = jstream.sharp_unlimited(d, sparse_feed=True, **kw)
    sparse_fed = sharp_unlimited(d, sparse_feed=True, device="cpu", **kw)
    dense_fed = sharp_unlimited(d, sparse_feed=False, fuse_batch=1, device="cpu", **kw)
    np.testing.assert_array_equal(sparse_fed.pred_clusters, ref.pred_clusters)
    np.testing.assert_array_equal(dense_fed.pred_clusters, ref.pred_clusters)


def test_unlimited_npz_directory_resume(tmp_path, blocked_data, same_rp):
    """A directory of .npz blocks matches the JAX package; a second run
    resumes from the manifest with identical labels; another configuration
    does not reuse it."""
    X, y, blocks = blocked_data
    d = str(tmp_path / "blocks")
    j_save_blocks(d, blocks)
    ref = jstream.sharp_unlimited(d, manifest_dir=str(tmp_path / "jm"), **KW)
    r1 = sharp_unlimited(d, device="cpu", **KW)
    np.testing.assert_array_equal(r1.pred_clusters, ref.pred_clusters)
    manifest = os.path.join(d, ".sharp_manifest")
    assert len(os.listdir(manifest)) == 3
    r2 = sharp_unlimited(d, device="cpu", **KW)
    np.testing.assert_array_equal(r1.pred_clusters, r2.pred_clusters)
    assert [s["stage"] for s in r2.timing["stages"]][:2] == ["rp_setup", "block_pass"]
    sharp_unlimited(d, device="cpu", **dict(KW, rN_seed=20))
    assert len(os.listdir(manifest)) == 6
    cfg = resolve_config(1000, 600, **KW)
    assert streaming._config_fingerprint(cfg) != streaming._config_fingerprint(cfg, "bfloat16")


def test_unlimited_single_matrix_and_single_block_degrade(tmp_path, same_rp):
    """A one-block list runs sharp(); a one-block directory keeps the
    block's consensus as the final clustering (no global re-fuse)."""
    X, y = make_tpm_like(n_cells=200, n_genes=300, n_types=3, seed=2)
    res = sharp_unlimited([X], rN_seed=4, ensize_K=4, device="cpu")
    ref = sharp_unlimited([sp.csr_matrix(X)], rN_seed=4, ensize_K=4, device="cpu")
    assert len(res.pred_clusters) == 200
    np.testing.assert_array_equal(res.pred_clusters, ref.pred_clusters)
    X1, y1 = make_tpm_like(n_cells=900, n_genes=600, n_types=5, seed=17)
    d = str(tmp_path / "oneblock")
    save_blocks(d, [X1], fmt="sblk")
    one = sharp_unlimited(d, device="cpu", **KW)
    jone = jstream.sharp_unlimited(d, manifest_dir=str(tmp_path / "jm"), **KW)
    np.testing.assert_array_equal(one.pred_clusters, jone.pred_clusters)
    assert ari(y1, one.pred_clusters) >= 0.9 and one.N_pred_cluster >= 4


def test_indN_cluster_dropped_for_a_one_fold_sblk_block_as_in_jax(tmp_path, same_rp, monkeypatch):
    """The JAX package keeps `indN_cluster` for a block of one fold only
    when it is dense (its one-fold program, `process_fold`); a SparseBlock
    of one fold takes its grouped pass, which drops it
    (sharp_tpu/parallel/streaming.py:70-94, sharded.py:31-37). One SBLK
    block of 240 cells (one fold) with indN_cluster=6, through the sparse
    feed and through the host densify: per-member cluster counts and labels
    identical to the JAX package's, the fixed count only on the dense
    feed."""
    X, _ = make_tpm_like(n_cells=240, n_genes=300, n_types=4, seed=8)
    d = str(tmp_path / "one_fold")
    save_blocks(d, [X], fmt="sblk")
    kw = dict(rN_seed=5, ensize_K=4, partition_ncells=250, indN_cluster=6, resume=False)

    def record(mod):
        seen, real = [], mod._fold_pass

        def spy(*a, **k):
            frs = real(*a, **k)
            seen.append(np.stack([fr["k_per"] for fr in frs]))
            return frs

        monkeypatch.setattr(mod, "_fold_pass", spy)
        return seen

    jk, tk = record(jstream), record(streaming)
    for sparse_feed in (True, False):
        ref = jstream.sharp_unlimited(d, sparse_feed=sparse_feed, manifest_dir=str(tmp_path / "jm"), **kw)
        got = sharp_unlimited(d, sparse_feed=sparse_feed, manifest_dir=str(tmp_path / "tm"), device="cpu", **kw)
        np.testing.assert_array_equal(got.pred_clusters, ref.pred_clusters)
    np.testing.assert_array_equal(np.stack(tk), np.stack(jk))
    sparse_k, dense_k = jk
    assert (dense_k == 6).all() and not (sparse_k == 6).all(), (sparse_k, dense_k)


def test_unlimited_forview_shapes(blocked_data, same_rp):
    X, y, blocks = blocked_data
    res = sharp_unlimited(blocks, forview=True, device="cpu", **KW)
    p = res.paras["reduced_ndim"]
    assert res.viE.shape == (1000, p)
    assert res.x0.shape == (1000, res.N_pred_cluster)
    own = res.x0[np.arange(1000), res.pred_clusters - 1]
    assert (own >= 0.5).mean() > 0.95


def test_view_rp_threshold():
    cfg = resolve_config(200_000, 600, rN_seed=7, forview=True)
    R = streaming._view_rp_matrix(cfg, 7)
    assert R is not None and R.shape == (cfg.reduced_ndim, 50)
    np.testing.assert_array_equal(R, streaming._view_rp_matrix(cfg, 7))
    assert set(np.unique(R * np.sqrt(50.0)).round(4)) <= {0.0, round(float(np.sqrt(np.sqrt(cfg.reduced_ndim))), 4),
                                                          -round(float(np.sqrt(np.sqrt(cfg.reduced_ndim))), 4)}
    frs = [{"mean_proj": np.ones((10, cfg.reduced_ndim), np.float32)}]
    assert streaming._block_view_features(frs, R).shape == (10, 50)
    small = resolve_config(1000, 600, rN_seed=7, forview=True)
    assert streaming._view_rp_matrix(small, 7) is None
    assert streaming._block_view_features(frs, None).shape == (10, cfg.reduced_ndim)


def test_unported_parts_raise(monkeypatch):
    """Nothing raises any more: multihost=True without torchrun's variables
    runs as one process, and n_devices=2 puts each block's two folds over two
    shards; both give the labels of one process on one device."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    X, _ = make_tpm_like(n_cells=500, n_genes=300, n_types=4, seed=5)
    blocks = [X[:200], X[200:350], X[350:]]
    kw = dict(rN_seed=3, ensize_K=3, base_ncells=200, partition_ncells=128, device="cpu")
    ref = sharp_unlimited(blocks, **kw)
    for extra in (dict(multihost=True), dict(n_devices=2)):
        got = sharp_unlimited(blocks, **extra, **kw)
        np.testing.assert_array_equal(got.pred_clusters, ref.pred_clusters)
        assert got.N_pred_cluster == ref.N_pred_cluster


def test_auto_group_sparse_branch(monkeypatch):
    from sharp_tpu_torch.parallel import sharded

    monkeypatch.setattr(sharded, "memory_budget_bytes", lambda dev: 8 << 30)
    # dense: 3 x 229 MB + 5 x 5 x 16.8 MB per fold -> 7 folds fit -> 4;
    # sparse: 2 x 229 MB + 419 MB -> 9 fit -> 8
    assert sharded.auto_group(2048, 27998, K=5, device="cpu") == 4
    assert sharded.auto_group(2048, 27998, sparse=True, K=5, device="cpu") == 8
    monkeypatch.setattr(sharded, "memory_budget_bytes", lambda dev: 1 << 28)
    assert sharded.auto_group(2048, 27998, sparse=True, K=5, device="cpu") == 1


def test_auto_group_under_the_hbm_budget(monkeypatch):
    """`SHARP_TPU_HBM_BUDGET` (bytes) is the memory budget, as in the JAX
    package (tests/test_streaming.py:314-329): a group of 1 at 256 MiB and
    the cap of 16 at 1 TiB in both packages, on both feeds; between them the
    port's model of a fold's working set (the linkage matrices besides the
    dense fold) gives smaller groups, and a smaller budget never a larger
    group."""
    from sharp_tpu.parallel import sharded as jsharded
    from sharp_tpu_torch.parallel import sharded

    monkeypatch.setenv("SHARP_TPU_HBM_BUDGET", str(1 << 28))
    assert sharded.memory_budget_bytes("cpu") == sharded.hbm_budget_bytes() == jsharded.hbm_budget_bytes() == 1 << 28
    for budget, want in ((1 << 28, 1), (1 << 40, 16)):
        monkeypatch.setenv("SHARP_TPU_HBM_BUDGET", str(budget))
        for sp_ in (False, True):
            assert jsharded.auto_group(2048, 27998, sparse=sp_) == want
            assert sharded.auto_group(2048, 27998, sp_, K=5, device="cpu") == want
            assert sharded.auto_group(2048, 27998, sp_, 4, K=5, device="cpu") == min(want, 4)
    for sp_ in (False, True):
        groups = []
        for budget in (1 << 28, 1 << 31, 4 << 30, 8 << 30, 12 << 30, 16 << 30, 1 << 40):
            monkeypatch.setenv("SHARP_TPU_HBM_BUDGET", str(budget))
            groups.append(sharded.auto_group(2048, 27998, sp_, K=5, device="cpu"))
            assert groups[-1] <= jsharded.auto_group(2048, 27998, sparse=sp_)
        assert groups == sorted(groups) and groups[0] == 1 and groups[-1] == 16, groups
    monkeypatch.setenv("SHARP_TPU_HBM_BUDGET", str(8 << 30))
    assert sharded.auto_group(2048, 27998, K=5, device="cpu") == 4
    assert sharded.auto_group(2048, 27998, True, K=5, device="cpu") == 8


@pytest.mark.parametrize("feed", ["dense", "sparse"])
def test_fold_timing_line(monkeypatch, capsys, feed):
    """`SHARP_TPU_FOLD_TIMING=1` prints the JAX package's `[fold-timing]`
    line with its four keys to stderr after the grouped pass, on both feeds,
    and changes no summary; without it, no line."""
    import re

    from sharp_tpu_torch.parallel.sharded import process_folds_grouped

    X, _ = make_tpm_like(n_cells=360, n_genes=200, n_types=3, seed=8)
    X[X < np.quantile(X, 0.6)] = 0.0
    cfg = resolve_config(360, 200, ensize_K=2, partition_ncells=120, rN_seed=2)
    R = torch.from_numpy(ternary(np.random.default_rng(1), 200, 2 * cfg.reduced_ndim))
    data = X if feed == "dense" else sparse.SparseBlock.from_scipy(sp.csr_matrix(X))
    plain = process_folds_grouped(data, [120] * 3, 128, R, cfg, True, 2, device="cpu")
    assert "[fold-timing]" not in capsys.readouterr().err
    monkeypatch.setenv("SHARP_TPU_FOLD_TIMING", "1")
    timed = process_folds_grouped(data, [120] * 3, 128, R, cfg, True, 2, device="cpu")
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("[fold-timing]")]
    assert len(lines) == 1
    m = re.fullmatch(r"\[fold-timing\] slice_s=(\d+\.\d\d) transfer_s=(\d+\.\d\d) "
                     r"device_s=(\d+\.\d\d) readback_s=(\d+\.\d\d)", lines[0])
    assert m, lines[0]
    assert float(m.group(3)) > 0.0   # the fold program ran
    for a, b in zip(timed, plain):
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_sparse_feed_equals_dense_feed_for_any_group():
    """The sparse feed's two staging sets are refilled by a worker thread
    while the fold loop densifies the other: with groups of 1 and 2 folds
    (every set reused) and a short thread switch interval, the summaries
    are the dense feed's."""
    import sys

    from sharp_tpu_torch.parallel.sharded import process_folds_grouped

    X, _ = make_tpm_like(n_cells=600, n_genes=300, n_types=4, seed=6)
    X[X < np.quantile(X, 0.6)] = 0.0
    cfg = resolve_config(600, 300, ensize_K=3, partition_ncells=120, rN_seed=2)
    R = torch.from_numpy(ternary(np.random.default_rng(0), 300, 3 * cfg.reduced_ndim))
    sizes = [120] * 5
    dense = process_folds_grouped(X, sizes, 128, R, cfg, True, group=5, device="cpu")
    sb = sparse.SparseBlock.from_scipy(sp.csr_matrix(X))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runs = [process_folds_grouped(sb, sizes, 128, R, cfg, True, group=g, device="cpu") for g in (1, 2)]
    finally:
        sys.setswitchinterval(old)
    for got in runs:
        assert len(got) == 5
        for a, b in zip(got, dense):
            for k in ("finalC", "n_meta", "counts", "k_per", "overflow"):
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
            # another row count in the RP product rounds the float sums apart
            np.testing.assert_allclose(a["cent_sum"], b["cent_sum"], rtol=1e-5, atol=1e-4)
