"""The port's parallel paths on the CPU: the mesh, the sharded fold pass
and its ensemble split, and several processes over one block stream.

Mirrors tests/test_sharded.py and tests/test_multihost.py. Mesh runs put
every shard on the CPU (the counterpart of the JAX tests' eight virtual
CPU devices), each on its own thread; labels must be bit-equal to one
device and to the JAX package's mesh runs with the same injected draws.
Two processes join a gloo group on localhost (tests/torch_mh_worker.py).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import sharp_tpu
import sharp_tpu.parallel.multihost as jmh
import sharp_tpu.parallel.streaming as jstream
import sharp_tpu_torch
from sharp_tpu.config import resolve_config as j_resolve_config
from sharp_tpu.parallel.mesh import resolve_mesh as j_resolve_mesh
from sharp_tpu_torch import carry
from sharp_tpu_torch.config import resolve_config
from sharp_tpu_torch.io.blocks import save_blocks
from sharp_tpu_torch.parallel import mesh, multihost
from tests.synth import make_tpm_like
from tests.test_torch_large import _jax_draws
from tests.test_torch_streaming import same_rp  # noqa: F401  (a fixture)
from tests.torch_mh_worker import inputs, run
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
CPU8 = ["cpu"] * 8


def _same(a, b, keys=("pred_clusters", "per_member_k", "folds")):
    for k in keys:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert a.N_pred_cluster == b.N_pred_cluster


def test_make_mesh_without_devices_raises_without_a_card(monkeypatch):
    """make_mesh() takes every CUDA card; with none it raises, as a CUDA
    request does, and builds no mesh on the CPU behind the caller's back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.make_mesh(n_data=1)
    assert mesh.make_mesh(devices=["cpu"]).flat() == [torch.device("cpu")]


def test_mesh_shapes_and_ensemble_axis_rejection(monkeypatch):
    m = mesh.make_mesh(n_data=4, n_ens=2, devices=CPU8)
    assert m.shape == {"data": 4, "ens": 2}
    assert len(m.flat()) == 8 and m.devices[3][1] == torch.device("cpu")
    assert mesh.make_mesh(devices=CPU8).shape == {"data": 8, "ens": 1}
    with pytest.raises(ValueError, match="needs 10 devices"):
        mesh.make_mesh(n_data=5, n_ens=2, devices=CPU8)
    kw = dict(ensize_K=4)
    assert mesh.resolve_mesh(resolve_config(900, 300, **kw), "cpu") is None
    assert mesh.resolve_mesh(resolve_config(900, 300, n_devices=4, **kw), "cpu").shape == {"data": 4, "ens": 1}
    assert mesh.resolve_mesh(resolve_config(900, 300, n_devices=8, ensemble_axis=2, **kw), "cpu").shape == {
        "data": 4, "ens": 2}
    # the JAX package's rule: ensemble_axis must divide ensize_K and n_devices
    for bad in (dict(n_devices=8, ensemble_axis=3), dict(n_devices=6, ensemble_axis=4)):
        with pytest.raises(ValueError, match="ensemble_axis"):
            mesh.resolve_mesh(resolve_config(900, 300, **kw, **bad), "cpu")
        with pytest.raises(ValueError, match="ensemble_axis"):
            j_resolve_mesh(j_resolve_config(900, 300, **kw, **bad))
    # shards wrap around the cards: three shards on one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.mesh_devices(3, "cuda") == [torch.device("cuda", 0)] * 3


def test_multihost_helpers_match_jax(monkeypatch):
    for n_blocks in (1, 5, 26, 27):
        for pc in (1, 2, 4, 8):
            slices = [multihost.block_slice(n_blocks, h, pc) for h in range(pc)]
            assert slices == [jmh.block_slice(n_blocks, h, pc) for h in range(pc)]
            assert [b for s in slices for b in s] == list(range(n_blocks))
    cents = np.arange(12, dtype=np.float32).reshape(3, 4)
    counts = np.asarray([5.0, 2.0, 1.0], np.float32)
    for a, b in zip(multihost.pad_block_summary(cents, counts, 8), jmh.pad_block_summary(cents, counts, 8)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="summary budget"):
        multihost.pad_block_summary(cents, counts, 2)
    # the degenerate single process: no torchrun variables, nothing joined
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.distributed_init() == (0, 1) == jmh.distributed_init()
    x = np.ones((3, 4), np.float32)
    np.testing.assert_array_equal(multihost.allgather_summaries(x), x)
    multihost.barrier()
    assert multihost.processes_per_card() == 1 and multihost.local_rank() == 0


def test_sharded_equals_one_device_with_uneven_folds():
    """Five folds over four data shards (one shard takes two): labels,
    member counts, folds and the view features bit-equal to one device."""
    X, y = make_tpm_like(n_cells=700, n_genes=500, n_types=4, seed=17)
    kw = dict(rN_seed=3, base_ncells=300, partition_ncells=150, ensize_K=3, forview=True, device="cpu")
    one = sharp_tpu_torch.sharp(X, **kw)
    four = sharp_tpu_torch.sharp(X, n_devices=4, **kw)
    assert one.folds.max() == 4
    _same(one, four)
    np.testing.assert_array_equal(one.viE, four.viE)
    np.testing.assert_array_equal(one.x0, four.x0)
    from sharp_tpu_torch.analysis.ari import ari

    assert ari(y, four.pred_clusters) >= 0.9


@pytest.fixture(scope="module")
def jax_case():
    """The large tier at 900 x 300 (4 folds) with the JAX package's draws
    injected into the port."""
    n, genes = 900, 300
    X, y = make_tpm_like(n_cells=n, n_genes=genes, n_types=5, seed=13)
    kw = dict(rN_seed=5, base_ncells=400, partition_ncells=250, ensize_K=4, prep=False, forview=True)
    cfg = resolve_config(n, genes, **kw)
    d = _jax_draws(n, genes, cfg.ensize_K, cfg.reduced_ndim, kw["rN_seed"])
    draws = dict(
        rM=d["R"],
        testlog_probe=carry.testlog_probe_from_jax(d["testlog_perm"], d["R_probe"], n, genes, cfg.reduced_ndim, device="cpu"),
        shuffle_perm=carry.shuffle_perm_from_jax(d["shuffle_perm"], n),
    )
    loop = sharp_tpu_torch.sharp(X, device="cpu", **draws, **kw)
    return dict(X=X, y=y, kw=kw, draws=draws, R=d["R"], loop=loop)


def test_sharded_matches_the_jax_mesh_run(jax_case):
    X, kw = jax_case["X"], jax_case["kw"]
    ref = sharp_tpu.sharp(X, rM=jax_case["R"], n_devices=4, **kw)
    got = sharp_tpu_torch.sharp(X, device="cpu", n_devices=4, **jax_case["draws"], **kw)
    _same(got, ref)
    _same(got, jax_case["loop"])


def test_ensemble_axis_matches_the_loop_and_the_jax_ens_run(jax_case):
    """Eight shards, four data x two ens: the K=4 members split two per ens
    shard. Labels bit-equal to one device and to the JAX package's ens run;
    the view features (mean_proj, the mean of the two shards' means, as the
    JAX package's pmean over "ens") within 1e-6 of the largest |viE| of
    the JAX ens run's, and of the one-device run's: the two packages' RP
    products sum in another order (their one-device runs differ as much)."""
    X, kw = jax_case["X"], jax_case["kw"]
    got = sharp_tpu_torch.sharp(X, device="cpu", n_devices=8, ensemble_axis=2, **jax_case["draws"], **kw)
    _same(got, jax_case["loop"])
    ref = sharp_tpu.sharp(X, rM=jax_case["R"], n_devices=8, ensemble_axis=2, **kw)
    _same(got, ref)
    scale = np.abs(ref.viE).max()
    assert np.abs(got.viE - ref.viE).max() <= 1e-6 * scale
    assert np.abs(got.viE - jax_case["loop"].viE).max() <= 1e-6 * scale


def test_unlimited_over_two_shards_equals_one_device(tmp_path):
    X, y = make_tpm_like(n_cells=700, n_genes=300, n_types=5, seed=41)
    save_blocks(str(tmp_path), [X[:300], X[300:500], X[500:]], fmt="sblk")
    kw = dict(rN_seed=19, ensize_K=4, partition_ncells=150, resume=False, device="cpu")
    one = sharp_tpu_torch.sharp_unlimited(str(tmp_path), **kw)
    two = sharp_tpu_torch.sharp_unlimited(str(tmp_path), n_devices=2, **kw)
    np.testing.assert_array_equal(one.pred_clusters, two.pred_clusters)
    assert one.N_pred_cluster == two.N_pred_cluster
    dense = sharp_tpu_torch.sharp_unlimited(str(tmp_path), n_devices=2, sparse_feed=False, **kw)
    np.testing.assert_array_equal(one.pred_clusters, dense.pred_clusters)


def _start_two_processes(tmp_path, mode):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_mh_worker.py"), str(rank), str(port), str(tmp_path), mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(2)
    ]
    return procs


def _finish(procs, tmp_path):
    try:
        for pr in procs:
            _, err = pr.communicate(timeout=120)
            assert pr.returncode == 0, err[-3000:]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    return [np.load(tmp_path / f"p{rank}.npz") for rank in range(2)]


@pytest.mark.parametrize("mode", ["basic", "budget"])
def test_two_gloo_processes_equal_one(tmp_path, mode, same_rp):
    """Two processes each cluster a disjoint slice of the blocks and meet at
    the summary all-gather: their labels, concatenated, equal one process's
    of the port and of the JAX package (`sharp_unlimited` on the same blocks
    with the same numpy RP matrix, `shared_rp`). In budget mode n_cells is
    forced to 2.1e6, so the widened cluster range (minN 42) must fit the
    all-gather's budget."""
    procs = _start_two_processes(tmp_path, mode)   # the references run meanwhile
    ref = run(mode)
    blocks, kw = inputs(mode)
    jref = jstream.sharp_unlimited(blocks, **kw)
    if mode == "budget":
        assert ref.N_pred_cluster >= 42, ref.N_pred_cluster
    p0, p1 = _finish(procs, tmp_path)
    both = np.concatenate([p0["labels"], p1["labels"]])
    np.testing.assert_array_equal(both, ref.pred_clusters)
    np.testing.assert_array_equal(both, jref.pred_clusters)
    assert int(p0["n"]) == int(p1["n"]) == ref.N_pred_cluster == jref.N_pred_cluster


def test_launch_counts_and_routes_hold_under_threads():
    """The shards count their launches from several threads: with a switch
    interval of 1 us and more threads than cores, no count of launches or
    of problems is lost, SHARD_LAUNCHES and SHARD_PROBLEMS keep each
    shard's own, and each thread reads its own ROUTES."""
    import threading

    from sharp_tpu_torch.ops import linkage_cuda as lc

    n_threads, per = 4 * (os.cpu_count() or 1), 2000
    before = lc.LAUNCHES["cutree"]
    before_problems = lc.PROBLEMS["cutree"]
    lc.SHARD_LAUNCHES.clear()
    lc.SHARD_PROBLEMS.clear()
    mine = {}

    def work(t):
        with lc.shard_scope((t, 0)):
            for _ in range(per):
                lc._count("cutree", 3)
                lc.ROUTES["cutree"] = t
                if lc.ROUTES["cutree"] != t:
                    mine[t] = "overwritten"
        mine.setdefault(t, lc.ROUTES["cutree"])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert lc.LAUNCHES["cutree"] - before == n_threads * per
    assert lc.PROBLEMS["cutree"] - before_problems == 3 * n_threads * per
    assert {k: v["cutree"] for k, v in lc.SHARD_LAUNCHES.items()} == {(t, 0): per for t in range(n_threads)}
    assert {k: v["cutree"] for k, v in lc.SHARD_PROBLEMS.items()} == {(t, 0): 3 * per for t in range(n_threads)}
    assert mine == {t: t for t in range(n_threads)}
    lc.SHARD_LAUNCHES.clear()
    lc.SHARD_PROBLEMS.clear()
