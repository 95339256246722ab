"""The port's fuse and quality scripts on the CPU, held against the JAX side:
`scripts/profile_fuse_torch.py`, `profile_fuse_batched_torch.py` and
`debug_bench_quality_torch.py`; and every one of the six `*_torch.py`
tuning and profiling scripts in a fresh process.

Inputs are numpy draws (the scripts' own, or tests/synth.py's) at small
sizes: blocks of 6 fake folds (NC_pad 256), centroid blocks at NC_pad 128
and 256, two folds of 250 and 175 cells x 300 genes (n_pad 256, K=2, p=16)
with the JAX package's RP matrix in bf16 given to both sides. Labels,
cluster counts and chosen k are integers and must be identical; the fold
line's silhouettes are rounded to 3 decimals, as the scripts print them.
One torch thread.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharp_tpu.analysis.ari import ari as j_ari
from sharp_tpu.config import resolve_config as j_resolve_config
from sharp_tpu.core import fold as jfold
from sharp_tpu.core import large as jlarge
from sharp_tpu.core.smetac import smetac as j_smetac
from sharp_tpu.ops.rp import ensemble_rp_matrix as j_rp_matrix
from tests.synth import make_tpm_like
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SCRIPTS = os.path.join(REPO, "scripts")
sys.path.insert(0, SCRIPTS)

import debug_bench_quality_torch as dbq  # noqa: E402
import profile_fuse as jfuse  # noqa: E402  (the JAX script: jax only inside its main)
import profile_fuse_batched_torch as pfb  # noqa: E402
import profile_fuse_torch as pfu  # noqa: E402

CPU = torch.device("cpu")


def test_fake_fold_results_are_the_jax_scripts():
    got = pfu.fake_fold_results(np.random.default_rng(0), T=6)
    ref = jfuse.fake_fold_results(np.random.default_rng(0), T=6)
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_fuse_folds_cold_warm_and_mocked_match_jax():
    """Two blocks of 6 fake folds (NC_pad 256, serial Ward): the script's
    warm fuses (which raise unless the cold fuse equals block 0's warm one
    and the fuses with smetac replayed give the warm labels) against the
    JAX package's fuse_folds with the JAX script's configuration."""
    rec, warm = pfu.run(CPU, n_blocks=2, T=6)
    assert rec["cold_equals_warm"] and rec["mocked_equals_warm"] and 0 < rec["host_share"]
    rng = np.random.default_rng(0)
    jcfg = j_resolve_config(1306127, 27998, ensize_K=5, reduced_ndim=256, partition_ncells=2000, rN_seed=7,
                            forview=False)
    for res in warm:
        ref = jlarge.fuse_folds(jfuse.fake_fold_results(rng, T=6), jcfg, n_total=pfu.N_TOTAL)
        np.testing.assert_array_equal(res.labels, ref.labels)
        assert res.n_final == ref.n_final


def test_batched_smetac_matches_jax():
    """NC_pad 128 and 256, G 1 and 2 (one batched call; the script raises
    unless each block alone gives the batch's result), at the flagship's
    widened range, against JAX's smetac (vmapped for G 2) on the same
    centroids."""
    rec, outs = pfb.run(CPU, nc_pads=(128, 256), gs=(1, 2), reps=1)
    assert (rec["minN"], rec["eff_maxN"]) == (26, 262)
    assert [(r["NC_pad"], r["G"]) for r in rec["rows"]] == [(128, 1), (128, 2), (256, 1), (256, 2)]
    for row, out in zip(rec["rows"], outs):
        cents, valid, NC, maxN, kw = out["data"]

        def one(c, v, **k):
            return j_smetac(c, v, jnp.asarray(NC), jnp.asarray(maxN), sil_thre=0.35, linkage_backend="auto",
                            **kw)

        if row["G"] == 1:
            ref = one(jnp.asarray(cents[0]), jnp.asarray(valid[0]))
        else:
            assert row["blocks_equal_alone"]
            ref = jax.vmap(one)(jnp.asarray(cents), jnp.asarray(valid))
        np.testing.assert_array_equal(out["tf"], np.asarray(ref.tf))
        np.testing.assert_array_equal(out["n_final"], np.asarray(ref.n_final))


@pytest.fixture(scope="module")
def quality_case():
    """NFOLD 2 of 600 cells x 300 genes (folds of 250, 175, 175; n_pad 256),
    K=2, p=16, the JAX package's RP matrix: the script's fold pass and fuse,
    and JAX's per-fold fold_program, summary_to_host and fuse_folds."""
    n_cells, genes, K, p, fold = 600, 300, 2, 16, 250
    X, y = make_tpm_like(n_cells=n_cells, n_genes=genes, n_types=5, seed=31)
    cfg = dbq.config(n_cells, genes, K, p, fold)
    sizes = jlarge.fold_sizes(n_cells, fold)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    B = 256

    def fold_data(t):
        Xf = np.zeros((B, genes), np.float32)
        yf = np.zeros(B, np.int64)
        Xf[: sizes[t]] = X[starts[t]: starts[t] + sizes[t]]
        yf[: sizes[t]] = y[starts[t]: starts[t] + sizes[t]]
        return Xf, yf

    def make_fold(t, b):
        assert b == B
        Xf, yf = fold_data(t)
        return torch.from_numpy(Xf), yf

    R = np.array(j_rp_matrix(jax.random.PRNGKey(7), K, genes, p, dtype=jnp.bfloat16).astype(jnp.float32))
    Rt = torch.from_numpy(R).to(torch.bfloat16)
    rec, labels = dbq.run(CPU, nfold=2, cfg=cfg, make_fold=make_fold, R_all=Rt)

    jcfg = j_resolve_config(n_cells, genes, ensize_K=K, reduced_ndim=p, partition_ncells=fold, rN_seed=7,
                            dtype_compute="bfloat16", forview=False)
    static = jfold.fold_static_args(jcfg)
    Rj = jnp.asarray(R, jnp.bfloat16)
    frs, truths, folds = [], [], []
    for t in range(2):
        Xf, yf = fold_data(t)
        s = jfold.fold_program(jnp.asarray(Xf), jnp.arange(B) < sizes[t], jnp.asarray(sizes[t]), Rj,
                               jnp.asarray(True), None, has_indN=False, **static)
        fr = jlarge.summary_to_host(s, sizes[t], forview=False)
        frs.append(fr)
        truths.append(yf[: sizes[t]])
        folds.append(dict(fold=t, k_per=fr["k_per"].tolist(), maxsil=np.round(fr["maxsil"], 3).tolist(),
                          n_meta=fr["n_meta"], fold_ARI=j_ari(yf[: sizes[t]], fr["finalC"])))
    fres = jlarge.fuse_folds(frs, jcfg, n_total=sum(sizes[:2]))
    return dict(rec=rec, labels=labels, cfg=cfg, make_fold=make_fold, Rt=Rt, jax_folds=folds, jax_frs=frs,
                jax_truths=truths, jax_labels=fres.labels, jax_n_final=fres.n_final, sizes=sizes)


def test_quality_script_fold_lines_and_fuse_match_jax(quality_case):
    c = quality_case
    got = [dbq.fold_line(f) for f in c["rec"]["folds"]]
    assert got == [dbq.fold_line(f) for f in c["jax_folds"]]
    np.testing.assert_array_equal(c["labels"], c["jax_labels"])
    assert c["rec"]["fuse"]["n_final"] == c["jax_n_final"]
    assert dbq.lines(c["rec"])[:2] == got


def test_quality_script_dump_has_the_jax_dumps_keys_and_shapes(quality_case, tmp_path):
    c = quality_case
    out = tmp_path / "fuse_debug.npz"
    dbq.dump_cents(str(out), CPU, nfold=2, cfg=c["cfg"], make_fold=c["make_fold"], R_all=c["Rt"])
    got = dict(np.load(out))
    frs = c["jax_frs"]
    ref = dict(cent_sum=np.stack([fr["cent_sum"] for fr in frs]), counts=np.stack([fr["counts"] for fr in frs]),
               finalC=np.concatenate([fr["finalC"] for fr in frs]), truth=np.concatenate(c["jax_truths"]),
               sizes=np.asarray(c["sizes"][:2]))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    for k in ("counts", "finalC", "truth", "sizes"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# each script's smallest run on the CPU, in a fresh interpreter
TINY = {
    "tune_linkage_rnn_torch": "m.run(cpu, group=1, n_pad=64, p=8, n_real=60, pair_caps=(16,), compact_ns=(32,), "
                              "reps=1, replica_caps=(16,))",
    "bench_linkage_backends_torch": "m.run(cpu, sizes=((64, 60),), r=1, members=2, p=8)",
    "profile_fold_torch": "m.profile(bench_torch.card_generator(50, 5, 64, cpu), "
                          "torch.ones((50, 16), dtype=torch.bfloat16), m.config(m.N_CELLS, 50, 2, 8), 1, cpu, "
                          "timed_groups=1, n_real=60)",
    "profile_fuse_torch": "m.run(cpu, n_blocks=1, T=3)",
    "profile_fuse_batched_torch": "m.run(cpu, nc_pads=(128,), gs=(1, 2), p=8, reps=1)",
    "debug_bench_quality_torch": "m.run(cpu, nfold=2, cfg=m.config(400, 50, 2, 8, 200), "
                                 "make_fold=m.card_folds(cpu, 50, 3), R_all=m.rp(cpu, m.config(400, 50, 2, 8, 200)))",
}


@pytest.mark.parametrize("script", sorted(TINY))
def test_script_loads_no_jax_and_refuses_cuda_without_a_card(script):
    """In a fresh interpreter: without a card, --device cuda (the default)
    raises; the script's smallest run on the CPU works, and no module of
    JAX or of the JAX package was loaded."""
    refuse = (
        "try:\n"
        "    m.main([])\n"
        "except RuntimeError as e:\n"
        "    assert 'torch.cuda.is_available() is False' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('ran without a card')\n"
    ) if not torch.cuda.is_available() else ""
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{SCRIPTS!r}, {REPO!r}]\n"
        f"import {script} as m\n"
        "import script_common_torch as common\n"
        "import bench_torch  # noqa: F401  (the fold script's generator)\n"
        + refuse +
        "torch.set_num_threads(1)\n"
        "cpu = torch.device('cpu')\n"
        f"{TINY[script]}\n"
        "common.check_modules()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
