"""The port's entry points on the CPU: no import of JAX or of the JAX
package, explicit devices, both tiers and the streaming path, and loud
refusals of what cannot run."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import sharp_tpu_torch
from sharp_tpu_torch import carry
from tests.synth import make_tpm_like
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, cwd=REPO, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def test_port_runs_without_importing_jax():
    """Both tiers of sharp() (the large one also over a mesh of four
    shards), sharp_unlimited() over SBLK files, the
    analysis functions and the CLI on the CPU load no module of JAX, none of
    the JAX package and, without a plot, no matplotlib (tests/conftest.py
    imports jax, so this runs in a fresh interpreter). Importing the package
    loads none of its modules."""
    code = (
        "import sys, tempfile\n"
        "sys.path.insert(0, 'tests')\n"
        "import numpy as np\n"
        "import sharp_tpu_torch\n"
        "assert not [m for m in sys.modules if m.startswith('sharp_tpu_torch.')]\n"
        "from sharp_tpu_torch.io.blocks import save_blocks\n"
        "from synth import make_tpm_like\n"
        "X, y = make_tpm_like(n_cells=120, n_genes=200, n_types=3, seed=1)\n"
        "res = sharp_tpu_torch.sharp(X, rN_seed=3, ensize_K=3, device='cpu')\n"
        "big = sharp_tpu_torch.sharp(X, rN_seed=3, ensize_K=3, base_ncells=100,\n"
        "                            partition_ncells=60, device='cpu')\n"
        "mesh = sharp_tpu_torch.sharp(X, rN_seed=3, ensize_K=4, base_ncells=100, partition_ncells=60,\n"
        "                             n_devices=4, ensemble_axis=2, device='cpu')\n"
        "assert len(mesh.pred_clusters) == 120 and mesh.per_member_k.shape == (2, 4)\n"
        "d = tempfile.mkdtemp()\n"
        "save_blocks(d, [X[:70], X[70:]], fmt='sblk')\n"
        "unl = sharp_tpu_torch.sharp_unlimited(d, rN_seed=3, ensize_K=3, partition_ncells=40,\n"
        "                                      resume=False, device='cpu')\n"
        "import sharp_tpu_torch.carry, sharp_tpu_torch.ops.linkage_cuda, sharp_tpu_torch.io.rdata\n"
        "assert len(res.pred_clusters) == 120 and big.folds.max() == 1\n"
        "assert len(unl.pred_clusters) == 120\n"
        "T = sharp_tpu_torch\n"
        "mk = T.get_marker_genes(X, res, device='cpu')\n"
        "mk2 = T.get_marker_genes_unlimited2([X[:, :90], X[:, 90:]], res, device='cpu')\n"
        "parts = T.get_percluster_exp([X[:70], X[70:]], res)\n"
        "emb, idx = T.visualization_embedding(res, n_iter=20, device='cpu')\n"
        "h = T.gethclust(1.0 - np.corrcoef(X[:40]), X[:40], device='cpu')\n"
        "cfg = T.resolve_config(120, 200)\n"
        "assert isinstance(cfg, T.SharpConfig) and T.ari(y, y) == 1.0\n"
        "assert mk.n_markers >= 1 and mk2.n_markers >= 1 and sum(len(v) for v in parts.values()) == 120\n"
        "assert emb.shape == (120, 2) and len(h['f']) == 40\n"
        "from sharp_tpu_torch.cli import main\n"
        "np.savez(d + '/X.npz', X=X)\n"
        "assert main(['cluster', d + '/X.npz', '--out', d + '/r.npz', '--rN-seed', '3', '--ensize-K', '3',\n"
        "             '--device', 'cpu']) == 0\n"
        "assert main(['markers', d + '/X.npz', d + '/r.npz', '--out', d + '/m.npz', '--device', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'sharp_tpu', 'matplotlib')\n"
        "             or m.startswith(('jax.', 'jaxlib.', 'sharp_tpu.', 'matplotlib.')))\n"
        "assert not bad, bad\n"
        "print('ok', res.N_pred_cluster, unl.N_pred_cluster)\n"
    )
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("ok")


def test_port_source_imports_nothing_of_the_jax_package():
    """No module of the port, not chip_smoke.py, not bench_torch.py and not
    the port's scripts name the JAX package or JAX in an import; matplotlib
    is imported only inside the plot functions (the machine with the card
    has none)."""
    import re

    pat = re.compile(
        r"^\s*(import (sharp_tpu|jax)\b(?!_torch)|from (sharp_tpu|jax)[ .](?!_torch))", re.M
    )
    mpl = re.compile(r"^\s*(import|from) matplotlib\b", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "bench_torch.py")]
    paths += [os.path.join(REPO, "scripts", f)
              for f in ("multihost_26block_torch.py", "bench_round.py", "repro_log2_load.py", "pbmc_routes.py")]
    for root, _, files in os.walk(os.path.join(REPO, "sharp_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    bad = [p for p in paths if pat.search(open(p).read())]
    assert not bad, bad
    plotting = os.path.join(REPO, "sharp_tpu_torch", "analysis", "plotting.py")
    assert [p for p in paths if mpl.search(open(p).read())] == [plotting]
    assert not re.search(r"^(import|from) matplotlib", open(plotting).read(), re.M)


def test_port_cpu_tests_run_on_one_torch_thread():
    """Every test file of the port that imports torch imports the one
    shared one-thread fixture (tests/torch_threads.py), except the card's
    tests and the surface scan, which run no CPU torch; and no test file
    carries a fixture of its own that sets one thread (a line that hands
    the call to a subprocess as a string is not one)."""
    import glob
    import re

    tests = os.path.join(REPO, "tests")
    uses_torch = re.compile(r"^(import torch\b|from torch[ .])", re.M)
    guard = re.compile(r"^from (tests\.)?torch_threads import one_torch_thread\b", re.M)
    own = re.compile(r"^\s+torch\.set_num_threads\(1\)", re.M)
    exempt = {"test_torch_cuda.py", "test_torch_surface.py"}
    unguarded, private = [], []
    for path in sorted(glob.glob(os.path.join(tests, "test_torch_*.py"))):
        src, name = open(path).read(), os.path.basename(path)
        if uses_torch.search(src) and name not in exempt and not guard.search(src):
            unguarded.append(name)
        if own.search(src):
            private.append(name)
    assert not unguarded, unguarded
    assert not private, private
    assert len(own.findall(open(os.path.join(tests, "torch_threads.py")).read())) == 1


def test_lazy_exports_match_the_jax_package():
    """Every public name of sharp_tpu has its counterpart in the port."""
    import sharp_tpu

    for name in sharp_tpu.__all__:
        assert name in sharp_tpu_torch.__all__, name
        assert callable(getattr(sharp_tpu_torch, name)), name
    with pytest.raises(AttributeError):
        sharp_tpu_torch.no_such_name


@pytest.mark.parametrize("n,genes,knobs", [
    (479, 20000, {}),
    (6000, 5000, {"exp_type": "TPM", "rN_seed": 2103}),
    (200_000, 27998, {"ensize_K": 5, "reduced_ndim": 256, "partition_ncells": 2000,
                      "dtype_compute": "bfloat16", "forview": False}),
    (1_306_127, 27998, {"maxN_cluster": 30, "base_ncells": 300, "logflag": True, "n_cores": 4}),
])
def test_config_matches_the_jax_package(n, genes, knobs):
    """The port's resolve_config echoes the JAX package's, field for field
    (results carry it as `paras`)."""
    from sharp_tpu.config import pad_dim as j_pad_dim
    from sharp_tpu.config import resolve_config as j_resolve
    from sharp_tpu_torch.config import pad_dim, resolve_config

    ours = resolve_config(n, genes, **knobs)
    assert ours.as_dict() == j_resolve(n, genes, **knobs).as_dict()
    assert ours.is_small == (n < ours.base_ncells)
    for k in (1, 8, 9, 500, 513, 1000, 2049):
        assert pad_dim(k) == j_pad_dim(k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ari_and_labels_match_the_jax_package(seed):
    from sharp_tpu.analysis.ari import rand_metrics as j_rand
    from sharp_tpu.types import finalize_labels as j_finalize
    from sharp_tpu_torch.analysis.ari import ari, rand_metrics
    from sharp_tpu_torch.types import finalize_labels

    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 5, 300)
    pred = np.where(rng.random(300) < 0.8, truth, rng.integers(0, 7, 300))
    assert rand_metrics(truth, pred) == j_rand(truth, pred)
    assert ari(truth, truth) == 1.0
    raw = rng.integers(0, 12, 20000)
    raw[:3] = 40
    for tiny in (False, True):
        np.testing.assert_array_equal(finalize_labels(raw, tiny), j_finalize(raw, tiny))


def test_large_tier_raises():
    """Nothing raises for several devices any more: the large tier's folds
    over two shards on the CPU give the one-device labels, and an
    ensemble_axis that does not divide ensize_K is refused."""
    X, _ = make_tpm_like(n_cells=150, n_genes=100, n_types=3, seed=0)
    kw = dict(rN_seed=1, ensize_K=2, base_ncells=100, partition_ncells=60, device="cpu")
    one = sharp_tpu_torch.sharp(X, **kw)
    two = sharp_tpu_torch.sharp(X, n_devices=2, **kw)
    np.testing.assert_array_equal(one.pred_clusters, two.pred_clusters)
    np.testing.assert_array_equal(one.per_member_k, two.per_member_k)
    with pytest.raises(ValueError, match="ensemble_axis"):
        sharp_tpu_torch.sharp(X, n_devices=2, ensemble_axis=2, **dict(kw, ensize_K=3))


def test_small_tier_above_1024_raises(monkeypatch):
    """Nothing raises above n_pad 1024 any more: "pallas_bf16" takes serial
    Ward with bf16 storage there (the JAX package's merge order, not the
    ladder's). The spy records the call and hands the linkage to the bf16
    ladder, which keeps the CPU run short."""
    from sharp_tpu_torch.ops import linkage as tlink
    from sharp_tpu_torch.ops import select as tsel

    calls = []

    def spy(D, store_dtype=torch.float32):
        calls.append((tuple(D.shape), store_dtype))
        return tlink.ward_linkage_rnn(D, store_dtype=store_dtype)

    monkeypatch.setattr(tsel, "ward_linkage_serial", spy)
    X, _ = make_tpm_like(n_cells=1100, n_genes=60, n_types=3, seed=2)
    res = sharp_tpu_torch.sharp(X, rN_seed=1, ensize_K=2, linkage_backend="pallas_bf16", device="cpu")
    assert res.paras["block_pad"] == 1536 and len(res.pred_clusters) == 1100
    assert ((2, 1536, 1536), torch.bfloat16) in calls


def test_small_tier_above_1024_runs_the_ladder():
    X, y = make_tpm_like(n_cells=1100, n_genes=60, n_types=3, seed=2)
    res = sharp_tpu_torch.sharp(X, rN_seed=1, ensize_K=2, device="cpu")
    assert res.paras["block_pad"] == 1536 and len(res.pred_clusters) == 1100
    from sharp_tpu_torch.analysis.ari import ari

    assert ari(y, res.pred_clusters) >= 0.9


@pytest.mark.parametrize("backend", ["rnn", "rnn_bf16", "pallas_bf16"])
def test_unported_linkage_backends_raise(backend):
    """Every backend is ported: the ladder backends and serial Ward with
    bf16 storage run, and raise only for an hmethod other than ward.D."""
    X, _ = make_tpm_like(n_cells=60, n_genes=100, n_types=2, seed=0)
    with pytest.raises(ValueError, match="ward.D only"):
        sharp_tpu_torch.sharp(X, linkage_backend=backend, hmethod="average", device="cpu")
    res = sharp_tpu_torch.sharp(X, linkage_backend=backend, rN_seed=1, ensize_K=2, device="cpu")
    assert len(res.pred_clusters) == 60


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    X, _ = make_tpm_like(n_cells=60, n_genes=100, n_types=2, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        sharp_tpu_torch.sharp(X)
    with pytest.raises(RuntimeError, match="cuda"):
        sharp_tpu_torch.get_opt_hclust(np.random.default_rng(0).normal(size=(30, 5)))
    with pytest.raises(RuntimeError, match="cuda"):
        sharp_tpu_torch.sharp_unlimited([X[:30], X[30:]])
    y = np.arange(60) % 2
    for call in (
        lambda: sharp_tpu_torch.get_marker_genes(X, y),
        lambda: sharp_tpu_torch.get_marker_genes_unlimited2([X[:, :50], X[:, 50:]], y),
        lambda: sharp_tpu_torch.visualization_embedding((X[:, :3], X[:, 3:9])),
        lambda: sharp_tpu_torch.gethclust(1.0 - np.corrcoef(X[:20]), X[:20]),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    with pytest.raises(ValueError, match="unsupported device"):
        sharp_tpu_torch.sharp(X, device="meta")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from sharp_tpu_torch.ops import _build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_carry_checks_shapes():
    R = carry.rp_from_jax(np.zeros((30, 12), np.float32), 3, 4, device="cpu")
    assert R.shape == (30, 12) and R.dtype == torch.float32
    with pytest.raises(ValueError, match="R_all"):
        carry.rp_from_jax(np.zeros((30, 11), np.float32), 3, 4, device="cpu")
    probe = carry.testlog_probe_from_jax(np.arange(5)[::-1], np.zeros((30, 4)), 5, 30, 4, device="cpu")
    assert probe.perm.tolist() == [4, 3, 2, 1, 0]
    with pytest.raises(ValueError, match="permutation"):
        carry.testlog_probe_from_jax(np.zeros(5, int), np.zeros((30, 4)), 5, 30, 4, device="cpu")
    with pytest.raises(ValueError, match="R_probe"):
        carry.testlog_probe_from_jax(np.arange(5), np.zeros((30, 3)), 5, 30, 4, device="cpu")
    perm = carry.shuffle_perm_from_jax(np.array([2, 0, 1]), 3)
    assert perm.tolist() == [2, 0, 1] and perm.dtype == torch.int64
    with pytest.raises(ValueError, match="permutation"):
        carry.shuffle_perm_from_jax(np.array([0, 0, 1]), 3)


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """chip_smoke.py and bench_torch.py exit non-zero and print no result
    (chip_smoke's "ok" line, the bench's metric) without a CUDA device,
    and in a directory that holds nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, result in (("chip_smoke.py", '"ok"'), ("bench_torch.py", '"metric"')):
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, script)], cwd=REPO,
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode != 0, script
        assert result not in out.stdout, script
        alone = tmp_path / script
        shutil.copy(os.path.join(REPO, script), alone)
        out = subprocess.run(
            [sys.executable, str(alone)], cwd=tmp_path, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode != 0, script
        assert result not in out.stdout, script
        alone.unlink()


def test_multihost_script_fails_without_a_card():
    """scripts/multihost_26block_torch.py with --device cuda (its default)
    and no card exits 1 and prints no record."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for args in ([], ["--device", "cuda", "--config", "mechanics"]):
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", "multihost_26block_torch.py"), *args], cwd=REPO,
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode == 1, (args, out.stderr[-2000:])
        assert "{" not in out.stdout and "is_available() is False" in out.stderr, args


def test_global_fuse_and_rp_matrix_default_to_the_card():
    """`parallel.streaming.global_block_fuse` and `ops.rp.ensemble_rp_matrix`
    run on the card unless asked for the CPU, as `sharp` does, and a CUDA
    request without a card raises; device="cpu" runs them here."""
    import inspect

    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch.ops.rp import ensemble_rp_matrix
    from sharp_tpu_torch.parallel.streaming import global_block_fuse

    for fn in (global_block_fuse, ensemble_rp_matrix):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    cfg = resolve_config(600, 100, rN_seed=1)
    rng = np.random.default_rng(0)
    summaries = [(rng.normal(size=(6, 8)).astype(np.float32), np.full(6, 50.0)) for _ in range(2)]
    assert ensemble_rp_matrix(3, 2, 100, 8, device="cpu").device.type == "cpu"
    tf, remap, offsets, order, sizes = global_block_fuse(summaries, cfg, device="cpu")
    assert len(tf) >= 12 and offsets.tolist() == [0, 6, 12] and sizes.sum() == 600
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ensemble_rp_matrix(3, 2, 100, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        global_block_fuse(summaries, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        global_block_fuse(summaries[:1], cfg)
