"""The port's CLI (`python -m sharp_tpu_torch`) on the CPU: its four
subcommands with --device cpu, result files that read in the JAX package's
CLI with the same marker table, the plots, and the error paths of
tests/test_cli_plotting.py."""

import json
import os

import numpy as np
import pytest
import torch

from sharp_tpu.cli import main as jax_cli
from sharp_tpu_torch.cli import main as cli
from tests.synth import make_tpm_like
from torch_threads import one_torch_thread  # noqa: F401

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    X, y = make_tpm_like(n_cells=200, n_genes=300, n_types=4, seed=8)
    xpath = str(d / "X.npz")
    np.savez(xpath, X=X, gene_names=np.array([f"G{i}" for i in range(300)]))
    rpath = str(d / "res.npz")
    assert cli(["cluster", xpath, "--out", rpath, "--rN-seed", "3", "--ensize-K", "4", *CPU]) == 0
    return d, xpath, rpath, X, y


def test_cli_cluster_result_layout(dataset):
    """The result file has the JAX CLI's keys and schema, and a rerun with
    the same seed gives the same labels."""
    from sharp_tpu_torch.analysis.ari import ari

    d, xpath, rpath, X, y = dataset
    with np.load(rpath, allow_pickle=True) as z:
        assert set(z.files) == {"pred_clusters", "x0", "viE", "paras", "timing"}
        labels = z["pred_clusters"]
        paras = json.loads(str(z["paras"]))
        assert z["x0"].shape[0] == 200 and z["viE"].shape == (200, paras["reduced_ndim"])
        assert json.loads(str(z["timing"]))
    assert paras["ensize_K"] == 4 and labels.min() == 1
    assert ari(y, labels) >= 0.9
    again = str(d / "res2.npz")
    assert cli(["cluster", xpath, "--out", again, "--rN-seed", "3", "--ensize-K", "4", *CPU]) == 0
    with np.load(again, allow_pickle=True) as z:
        np.testing.assert_array_equal(labels, z["pred_clusters"])


def test_cli_markers_match_the_jax_cli(dataset):
    """`markers` on the same X and the port's result file: identical mg_*
    columns in both CLIs (the JAX CLI reads the port's result file)."""
    d, xpath, rpath, X, y = dataset
    ours, theirs = str(d / "m.npz"), str(d / "m_jax.npz")
    assert cli(["markers", xpath, rpath, "--out", ours, *CPU]) == 0
    assert jax_cli(["markers", xpath, rpath, "--out", theirs]) == 0
    with np.load(ours, allow_pickle=True) as a, np.load(theirs, allow_pickle=True) as b:
        assert set(a.files) == set(b.files) >= {
            "mg_gene", "mg_gene_index", "mg_cluster", "mg_sparsity",
            "mg_auc", "mg_pvalue", "mg_p_adj", "mg_fold_change",
        }
        for k in ("mg_gene", "mg_gene_index", "mg_cluster", "mg_sparsity", "mg_auc"):
            np.testing.assert_array_equal(a[k], b[k])
        # z differs in the last bit (tests/test_torch_analysis.py)
        for k in ("mg_pvalue", "mg_p_adj", "mg_fold_change"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-300)
        with np.load(rpath) as r:
            assert set(np.unique(a["mg_cluster"])) == set(np.unique(r["pred_clusters"]))


def test_cli_embed_and_plots(dataset):
    """`embed` on the port's result; `--plot` writes real PNGs."""
    pytest.importorskip("matplotlib")
    d, xpath, rpath, X, y = dataset
    epath, eplot = str(d / "emb.npz"), str(d / "emb.png")
    assert cli(["embed", rpath, "--out", epath, "--plot", eplot, *CPU]) == 0
    with np.load(epath) as z:
        assert set(z.files) == {"embedding", "cell_indices"}
        assert z["embedding"].shape == (200, 2) and np.all(np.isfinite(z["embedding"]))
    mplot = str(d / "m.png")
    assert cli(["markers", xpath, rpath, "--out", str(d / "m2.npz"), "--plot", mplot, *CPU]) == 0
    assert os.path.getsize(eplot) > 1000 and os.path.getsize(mplot) > 1000


def test_cli_unlimited_forview_embed(tmp_path):
    """unlimited --forview carries viE/x0 into the result and `embed` runs on
    it; without the view planes `embed` fails loud."""
    from sharp_tpu_torch.io.blocks import save_blocks

    X, _ = make_tpm_like(n_cells=240, n_genes=200, n_types=3, seed=6)
    bdir = str(tmp_path / "blocks")
    save_blocks(bdir, [X[:80], X[80:160], X[160:]], fmt="sblk")
    knobs = ["--rN-seed", "3", "--ensize-K", "3", "--base-ncells", "100", "--partition-ncells", "64"]
    rpath = str(tmp_path / "res_u.npz")
    assert cli(["unlimited", bdir, "--out", rpath, "--forview", *knobs, *CPU]) == 0
    with np.load(rpath, allow_pickle=True) as z:
        assert z["viE"].shape[0] == 240 and z["x0"].shape[0] == 240
    epath = str(tmp_path / "emb.npz")
    assert cli(["embed", rpath, "--out", epath, *CPU]) == 0
    with np.load(epath) as z:
        assert z["embedding"].shape == (240, 2)
    bare = str(tmp_path / "res_nv.npz")
    assert cli(["unlimited", bdir, "--out", bare, "--no-resume", *knobs, *CPU]) == 0
    with pytest.raises(ValueError, match="forview"):
        cli(["embed", bare, "--out", str(tmp_path / "e2.npz"), *CPU])


def test_cli_error_paths(tmp_path, dataset, monkeypatch):
    """Bad invocations fail loudly: argparse exit 2, missing files raise, a
    card requested where there is none raises. Several shards and several
    processes run: `--n-devices 2` clusters with the one-device labels, and
    `--multihost` without torchrun's variables runs as one process."""
    d, xpath, rpath, X, y = dataset
    with pytest.raises(SystemExit) as e:
        cli(["cluster"])
    assert e.value.code == 2
    with pytest.raises(FileNotFoundError):
        cli(["cluster", str(tmp_path / "nope.npz"), "--out", str(tmp_path / "o.npz"), *CPU])
    with pytest.raises(SystemExit):
        cli([])
    large = ["--rN-seed", "3", "--ensize-K", "3", "--base-ncells", "100", "--partition-ncells", "60", *CPU]
    runs = {}
    for name, extra in (("one", []), ("two", ["--n-devices", "2"])):
        assert cli(["cluster", xpath, "--out", str(tmp_path / f"{name}.npz"), *large, *extra]) == 0
        runs[name] = np.load(tmp_path / f"{name}.npz")["pred_clusters"]
    np.testing.assert_array_equal(runs["one"], runs["two"])
    from sharp_tpu_torch.io.blocks import save_blocks

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    blocks = str(tmp_path / "blocks")
    save_blocks(blocks, [X[:120], X[120:]], fmt="sblk")
    for name, extra in (("u_one", []), ("u_mh", ["--multihost"])):
        assert cli(["unlimited", blocks, "--out", str(tmp_path / f"{name}.npz"), "--no-resume", *large, *extra]) == 0
        runs[name] = np.load(tmp_path / f"{name}.npz")["pred_clusters"]
    np.testing.assert_array_equal(runs["u_one"], runs["u_mh"])
    if not torch.cuda.is_available():
        for argv in (["cluster", xpath], ["markers", xpath, rpath], ["embed", rpath]):
            with pytest.raises(RuntimeError, match="cuda"):
                cli([*argv, "--out", str(tmp_path / "o.npz")])
