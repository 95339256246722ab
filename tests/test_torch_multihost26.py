"""scripts/multihost_26block_torch.py on the CPU, held against the JAX package.

All 26 blocks, reduced in cells and genes only (120 cells x 200 genes a
block, one fold each): the mechanics configuration's knobs and n_cells
declared 1,306,127, so the >= 1e6 widening is live. The script's two gloo
processes (one torch thread each) run with one numpy RP matrix
(`torch_mh_worker.shared_rp`) that the JAX package's one-process
`sharp_unlimited` gets too; the JAX reference runs once, while the cold
pair runs. The quality configuration's knobs at the same size: two
processes equal the port's one process (its ARI gate is for the full size).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import sharp_tpu.parallel.streaming as jstream
from sharp_tpu.parallel.multihost import block_slice as jax_block_slice
from sharp_tpu_torch.parallel.multihost import block_slice

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))

import multihost_26block_torch as mh  # noqa: E402
from tests.torch_mh_worker import shared_rp  # noqa: E402

GENES, CELLS = 200, 120
KW = dict(mh.KW, partition_ncells=CELLS)
TIMEOUT = 300


@pytest.fixture(scope="module")
def mech(tmp_path_factory):
    """The mechanics runs: the script's cold pair (the JAX package's one
    process meanwhile), then its resume pair."""
    work = str(tmp_path_factory.mktemp("mh26"))
    rp = os.path.join(work, "rp.npy")
    np.save(rp, shared_rp(KW["ensize_K"], GENES, KW["reduced_ndim"]))
    seen = {}

    def jax_reference(ddir, kw):
        seen["kw"] = kw
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jstream, "ensemble_rp_matrix",
                       lambda key, K, m, p, dtype=jnp.float32: jnp.asarray(shared_rp(K, m, p), dtype))
            r = jstream.sharp_unlimited(ddir, resume=False, manifest_dir=os.path.join(work, "jax_manifest"), **kw)
        return r.pred_clusters, r.N_pred_cluster

    rec, runs = mh.run_mechanics(work, "cpu", n_genes=GENES, block_cells=CELLS, kw=KW, rp=rp, threads=1,
                                 timeout=TIMEOUT, reference=jax_reference)
    return dict(rec=rec, runs=runs, work=work, **seen)


@pytest.fixture(scope="module")
def qual(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("mh26q"))
    return mh.run_quality(work, "cpu", n_genes=GENES, block_cells=CELLS, threads=1, timeout=TIMEOUT, min_ari=None)


@pytest.mark.parametrize("run", ["cold", "resume"])
def test_two_processes_equal_the_jax_package(mech, run):
    """The two processes' labels, concatenated, and each one's cluster count
    equal the JAX package's one process on the same directory, declared
    size, knobs and RP matrix."""
    jlabels, jn = mech["runs"]["single"]
    p0, p1 = mech["runs"][run]
    assert mech["kw"]["n_cells"] == 1_306_127
    assert len(p0["labels"]) == len(p1["labels"]) == 13 * CELLS
    np.testing.assert_array_equal(np.concatenate([p0["labels"], p1["labels"]]), jlabels)
    assert p0["n"] == p1["n"] == jn


def test_cold_run_writes_26_manifests_of_one_fingerprint(mech):
    names = sorted(os.listdir(os.path.join(mech["work"], "manifest_mechanics")))
    assert names == sorted(mech["runs"]["manifest_stamps"])
    assert [n.split("_")[1] for n in names] == [f"{i:05d}" for i in range(26)]
    assert len({n.rsplit("_", 1)[1] for n in names}) == 1
    assert mech["rec"]["manifests_written"] == 26


def test_resume_recomputes_no_block(mech):
    """The cold pair ran the fold pass on 13 blocks a process; the resume
    pair on none, and left every manifest as the cold pair wrote it."""
    assert [p["blocks_run"] for p in mech["runs"]["cold"]] == [13, 13]
    assert [p["blocks_run"] for p in mech["runs"]["resume"]] == [0, 0]
    mdir = os.path.join(mech["work"], "manifest_mechanics")
    stamps = {f: os.stat(os.path.join(mdir, f)).st_mtime_ns for f in os.listdir(mdir)}
    assert stamps == mech["runs"]["manifest_stamps"]


def test_quality_two_processes_equal_one(qual):
    rec, runs = qual
    labels, n = runs["single"]
    p0, p1 = runs["cold"]
    np.testing.assert_array_equal(np.concatenate([p0["labels"], p1["labels"]]), labels)
    assert p0["n"] == p1["n"] == n
    assert rec["two_process_equals_single_process"] and "resume_seconds" not in rec


@pytest.mark.parametrize("h", [0, 1])
def test_block_slice_splits_26_blocks_13_and_13_as_jax(h):
    assert block_slice(26, h, 2) == list(jax_block_slice(26, h, 2)) == list(range(13 * h, 13 * h + 13))
