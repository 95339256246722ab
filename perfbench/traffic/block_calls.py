"""Traffic `block_calls`: closed-loop calls of `sharp_tpu_torch.sharp` on
one host-resident block of an atlas at the API's defaults, back to back
(one caller that waits for each answer).

Set-up makes the block on the card from the seed by the atlas's recipe
(`data/atlas.AtlasData`, one fold of rows at a time) and copies it into a
numpy array in host memory once; it draws the stacked RP matrices `rM` on
the card and the cell permutation (`shuffle_perm`, kept on the host), the
call's two random draws, handed in through `sharp()`'s injection hooks.
The call passes nothing else but the seed and the device, so every knob is
the API's default for the block's size; the configuration's `knobs`, for
tests at small sizes only, are passed as they are. After the warm-up calls
set-up holds the resolved knobs (`SharpResult.paras`) to the ones the
configuration states. Every call gets the same inputs, so each answer is
the same: the check runs the plain reference of the large tier
(`reference/large.py`, every fold) once on them and holds the last answer
and a sample of earlier ones, drawn from the seed, against it.

params: warm_calls, profile_calls, check_calls, limits.
"""

from __future__ import annotations

import resource

import numpy as np
import torch

from perfbench.data.atlas import AtlasData, seeds, ternary_rp
from perfbench.reference import cluster
from perfbench.reference import large
from perfbench.reference.cluster import full_float32
from perfbench.reference.compare import ari, judge, label_gap, rel_err, worst

# knobs the configuration states, as `SharpResult.paras` names them
STATED = ("ensize_K", "reduced_ndim", "partition_ncells", "maxN_cluster", "prep", "dtype_compute", "forview",
          "linkage_backend")


class Driver:
    annotations = ()

    def __init__(self, cfg: dict, params: dict, seed: int, dev, spans, control: bool = False):
        self.c, self.p, self.seed, self.dev, self.spans = cfg, params, seed, dev, spans
        self.control = control
        self.answers = []
        self.lanes = None

    def setup(self) -> None:
        c = self.c
        n, genes, B = c["n_cells"], c["n_genes"], c["partition_ncells"]
        s_data, s_rp, s_perm, self.s_check = seeds(self.seed, 4)
        data = AtlasData(genes, c["n_types"], B, s_data, self.dev)
        self.X = np.empty((n, genes), np.float32)
        truth = []
        fold = torch.empty((B, genes), device=self.dev)
        for t in range(-(-n // B)):
            m = min(B, n - t * B)
            data.fold_into(t, fold)
            torch.from_numpy(self.X[t * B : t * B + m]).copy_(fold[:m])
            truth.append(data.planted(t)[:m].cpu().numpy())
        self.truth = np.concatenate(truth)
        del data, fold
        self.R = ternary_rp(genes, c["ensize_K"] * c["reduced_ndim"], s_rp, self.dev)
        g = torch.Generator(device=self.dev)
        g.manual_seed(s_perm)
        self.perm = torch.randperm(n, generator=g, device=self.dev).cpu()
        if self.control:
            # the program's own lower precision: its float32 products in TF32
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        for _ in range(self.p.get("warm_calls", 1)):
            res = self._call()
        wrong = {k: (res.paras[k], c[k]) for k in STATED if res.paras[k] != c[k]}
        if wrong:
            raise ValueError(f"the call resolved other knobs than the configuration states: {wrong}")

    def _call(self):
        from sharp_tpu_torch import sharp

        return sharp(self.X, rM=self.R, shuffle_perm=self.perm, rN_seed=7, device=self.dev,
                     **self.c.get("knobs", {}))

    def solve(self) -> dict:
        res = self._call()
        stages = {r["stage"]: r["seconds"] for r in res.timing["stages"]}
        feed = res.timing.get("fold_pass")      # None where the program does not report it
        self.answers.append(dict(labels=res.pred_clusters, folds=res.folds, viE=res.viE,
                                 maxsil=res.per_member_maxsil, k_per=res.per_member_k))
        return {"cells": int(self.c["n_cells"]), "fold_ensemble_s": stages.get("fold_ensemble"),
                "dense_feed_s": feed["slice_s"] + feed["transfer_s"] if feed else None, "stages": stages}

    def profile_segment(self):
        """`profile_calls` calls, the lanes of each fold-program call kept."""
        import sharp_tpu_torch.parallel.sharded as sharded

        inner, lanes = sharded.fold_program, []

        def counted(Xg, *a, **k):
            lanes.append(int(Xg.shape[0]))
            return inner(Xg, *a, **k)

        sharded.fold_program = counted
        recs = []
        try:
            for _ in range(self.p.get("profile_calls", 2)):
                recs.append(self.solve())
                self.answers.pop()
        finally:
            sharded.fold_program = inner
        self.lanes = lanes
        return recs

    def layer_context(self) -> dict:
        # the input any feed has to move to the card: the call's cells, float32
        return {"input_bytes_per_call": float(self.c["n_cells"] * self.c["n_genes"] * 4)}

    def release(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def reference(self, prefer=None) -> large.LargeRef:
        """The plain reference of the large tier on the call's inputs."""
        c = self.c
        cfg = large.config(c["n_cells"], c["ensize_K"], p=c["reduced_ndim"], partition_ncells=c["partition_ncells"],
                           maxN_cluster=c["maxN_cluster"])
        with full_float32():
            return large.sharp_large(self.X, self.R, self.perm.numpy(), cfg, self.dev, prefer=prefer)

    def check(self, records) -> dict:
        rng = np.random.default_rng(self.s_check)
        cluster.reset_readings()
        n = len(self.answers)
        idx = sorted({n - 1} | set(rng.choice(n, min(self.p.get("check_calls", 3), n), replace=False).tolist()))
        last = self.answers[-1]
        ref = self.reference(prefer={"k_per": last["k_per"], "labels": last["labels"]})
        picked = [self.answers[i] for i in idx]
        numbers = {
            "fold_gap": worst(float((a["folds"] != ref.folds).sum()) for a in picked),
            "k_gap": worst(float(np.abs(a["k_per"] - ref.k_per).max()) for a in picked),
            "maxsil_err": worst(float(np.abs(a["maxsil"] - ref.maxsil).max()) for a in picked),
            "viE_err": worst(rel_err(a["viE"], ref.viE) for a in picked),
            "label_gap": worst(label_gap(a["labels"], ref.labels) for a in picked),
        }
        self._checked = idx
        return judge(numbers, self.p["limits"])

    def info(self, records) -> dict:
        if not self.answers or not records:
            return {}
        last = self.answers[-1]["labels"]
        stages = {k: float(np.median([r["stages"][k] for r in records])) for k in records[0]["stages"]}
        return {"checked_calls": getattr(self, "_checked", []), "calls": len(self.answers),
                "ari_vs_planted": ari(self.truth, last), "n_clusters": int(len(np.unique(last))),
                "median_stage_s": stages, "fold_program_lanes": self.lanes,
                "host_peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
                "rule_chain": cluster.readings()}
