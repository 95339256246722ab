"""The comparison that decides `correct`, at small sizes on the CPU: it
passes for the port's outputs, and fails for outputs computed in a lower
precision than the configuration states, for one fold's labels permuted,
and for runs whose timed path is broken underneath (an answer altered
where it is produced; half of a fold group left out). The control at the
cells' own sizes is the `cuda` test at the end."""

import numpy as np
import pytest
import torch

from conftest import ATLAS_SMALL, WANG_SMALL
from perfbench.lib import registry
from perfbench.lib.spans import Spans
from perfbench.reference import cluster, compare, meta
from perfbench.run import run_cell

ATLAS = "flagship_1p3m.device_fed"
WANG = "wang_pancreas_479.repeat_calls"
CPU = torch.device("cpu")
SEED = 2**31 + 12345


def _small(cell, **params):
    wl = registry.workload(cell)
    wl["params"].update(params)
    return wl, ATLAS_SMALL if cell == ATLAS else WANG_SMALL


def _params(cell, params):
    return {**({"group": 4, "check_folds": 3} if cell == ATLAS else {}), **params}


def _run(cell, seconds=1.0, control=False, **params):
    wl, cfg = _small(cell, **_params(cell, params))
    return run_cell(cell, SEED, seconds, False, dev=CPU, wl=wl, cfg=cfg, control=control)


def _driver(cell, **params):
    wl, cfg = _small(cell, **_params(cell, params))
    drv = registry.driver(wl)(cfg, wl["params"], SEED, CPU, Spans(False))
    drv.setup()
    return drv


@pytest.mark.parametrize("cell", [ATLAS, WANG])
def test_port_outputs_pass(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    # sound runs read at rounding level or exactly
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], name


def test_atlas_fp8_operands_fail():
    """The program's RP product with float8 operands where bfloat16 is stated."""
    res = _run(ATLAS, control=True)
    assert not res["correct"]
    assert res["checks"]["centroid_err"]["value"] > res["checks"]["centroid_err"]["limit"]


def test_wang_tf32_products_fail():
    """The reference computed with TF32 products put in the program's place
    (the CPU has no TF32 path of the program's own)."""
    drv = _driver(WANG)
    drv.solve()
    labels, viE, maxsil = drv.reference("tf32")
    drv.answers[-1].update(labels=labels, viE=viE, maxsil=maxsil)
    checks = drv.check([{}])
    assert not all(c["ok"] for c in checks.values())
    assert not checks["viE_err"]["ok"]


def test_atlas_permuted_fold_labels_fail():
    drv = _driver(ATLAS)
    drv.solve()
    rng = np.random.default_rng(drv.s_check)
    sol = drv.solutions[int(rng.integers(len(drv.solutions)))]
    T = len(drv.plan)
    b, _ = drv.plan[T - 1]                  # the last fold is always checked
    fr = sol["block_frs"][b][-1]
    fr["finalC"] = np.random.default_rng(0).permutation(fr["finalC"])
    checks = drv.check([{}])
    assert not checks["fold_label_gap"]["ok"] and not checks["centroid_err"]["ok"]


@pytest.mark.parametrize("field", ["cent_sum", "counts"])
def test_atlas_unsampled_fold_summary_altered_fails(field):
    """A fold that the whole reference does not rerun: its summary, which
    the fuses read, is still held against the reference's projection."""
    drv = _driver(ATLAS)
    drv.solve()
    assert all(c["ok"] for c in drv.check([{}]).values())
    sol, folds = drv._checked
    t = next(t for t in range(len(drv.plan)) if t not in folds)
    b = drv.plan[t][0]
    fr = sol["block_frs"][b][t - [bb for bb, _ in drv.plan].index(b)]
    fr[field] = fr[field].copy()
    fr[field][int(fr["finalC"][0])] *= 1.001
    checks = drv.check([{}])
    assert not checks["centroid_err" if field == "cent_sum" else "count_gap"]["ok"]


def test_wang_permuted_labels_fail():
    drv = _driver(WANG)
    drv.solve()
    drv.answers[-1]["labels"] = np.random.default_rng(0).permutation(drv.answers[-1]["labels"])
    assert not drv.check([{}])["label_gap"]["ok"]


def test_answer_altered_where_produced_fails(monkeypatch):
    """Each fold's consensus labels shifted by one cell as the fold program
    returns them; and the small tier's wMetaC labels likewise."""
    import sharp_tpu_torch.core.fold as fold
    import sharp_tpu_torch.core.pipeline as pipeline

    inner_fold = fold.fold_program

    def shifted_fold(*a, **k):
        out = inner_fold(*a, **k)
        return out._replace(finalC=torch.roll(out.finalC, 1, dims=-1))

    monkeypatch.setattr(fold, "fold_program", shifted_fold)
    assert not _run(ATLAS)["correct"]
    inner_w = pipeline.wmetac

    def shifted_w(*a, **k):
        out = inner_w(*a, **k)
        return out._replace(finalC=torch.roll(out.finalC, 1, dims=-1))

    monkeypatch.setattr(pipeline, "wmetac", shifted_w)
    assert not _run(WANG)["correct"]


def test_half_of_fold_group_left_out_fails(monkeypatch):
    """The fold program solving the first half of a group's lanes and
    handing their results to the other half."""
    import sharp_tpu_torch.core.fold as fold

    inner = fold.fold_program

    def half(X, mask, n_real, *a, **k):
        G = X.shape[0]
        h = (G + 1) // 2
        out = inner(X[:h], mask[:h], list(n_real)[:h], *a, **k)
        idx = torch.arange(G) % h
        return type(out)(*(t[idx.to(t.device)] for t in out))

    monkeypatch.setattr(fold, "fold_program", half)
    assert not _run(ATLAS, check_folds=9)["correct"]


def test_reference_pieces():
    """The reference's pieces on hand-checkable inputs."""
    assert compare.ari([0, 0, 1, 1], [5, 5, 7, 7]) == 1.0
    assert compare.label_gap([0, 0, 1, 1], [0, 1, 0, 1]) > 0.9
    # ward on four points on a line: the close pairs merge first
    x = torch.tensor([[0.0], [1.0], [10.0], [11.5]])
    D = torch.cdist(x, x)[None]
    merges, heights = cluster.ward(D)
    assert merges[0, 0].tolist() == [0, 1] and merges[0, 1].tolist() == [2, 3]
    assert cluster.cuts(merges, [2])[0, 0].tolist() == [0, 0, 1, 1]
    assert cluster.round_operand(torch.tensor([1.0 + 2**-12]), "tf32").item() == 1.0
    assert meta.finalize(np.array([3, 3, 1, 2]), merge_tiny=False).tolist() == [1, 1, 2, 3]
    assert meta.smetac_range(2_000_000, 2, 262, 1000) == (40, 400)


def test_choice_within_rounding_of_a_threshold_is_admissible():
    """A candidate 1.8e-7 below the near-tie threshold (the reading that
    split a card's block fuse from the reference's): the reference's choice
    stays first, and the choice the near-tie re-rank makes with the
    candidate in is admissible too; far from any threshold, one choice."""
    f32 = np.float32
    n, minN, ncand = 100, 2, 6
    heights = np.linspace(0.01, 1.0, n - 1).astype(f32)
    heights[n - 4:] = [50.0, 51.0, 52.0]                    # a big jump above the cut at k = 4
    valid = np.ones(ncand, bool)
    msil = np.array([0.90, 0.95, 0.9843, 0.9844, 0.97, 0.96], f32)
    msil[2] = f32(msil[3] - cluster.SIL_TIE_EPS) - f32(1.8e-7)
    ch = np.zeros(ncand, f32)
    alts, rooms = cluster.choose(msil, ch, valid, heights, n, minN, ncand, 0.35, 2.0)
    assert alts == [3, 2] and rooms == [None, ("sil", 2e-7)]
    msil[2] = 0.5
    assert cluster.choose(msil, ch, valid, heights, n, minN, ncand, 0.35, 2.0) == ([3], [None])


def test_rule_chain_readings():
    """The readings say how many problems were chosen, how close each
    comparison came, and the room each choice other than the first took."""
    cluster.reset_readings()
    f32 = np.float32
    n, ncand = 100, 6
    heights = np.linspace(0.01, 1.0, n - 1).astype(f32)
    heights[n - 4:] = [50.0, 51.0, 52.0]
    msil = np.array([0.90, 0.95, 0.9843, 0.9844, 0.97, 0.96], f32)
    msil[2] = f32(msil[3] - cluster.SIL_TIE_EPS) - f32(1.8e-7)
    alts, rooms = cluster.choose(msil, np.zeros(ncand, f32), np.ones(ncand, bool), heights, n, 2, ncand, 0.35, 2.0)
    cluster.note_taken(rooms[1])
    r = cluster.readings()
    assert r["problems"] == 1 and r["non_primary"] == 1 and r["rooms_taken"] == [["sil", 2e-7]]
    assert r["closest"]["sil_tie"] < 1e-6 and abs(r["closest"]["sil_thre"] - (msil.max() - 0.35)) < 1e-6
    cluster.reset_readings()
    assert cluster.readings()["problems"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [ATLAS, WANG])
def test_control_at_cell_size_fails(cell):
    """The control at the cell's own size on the card: three seeds, each
    read not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench.control import readings

    for rec in readings(cell, (SEED + 1, SEED + 2, SEED + 3), 5.0):
        assert not rec["correct"], rec
