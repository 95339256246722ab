"""Traffic `repeat_calls`: closed-loop calls of `sharp_tpu_torch.sharp` on
one host-resident expression matrix, back to back (one caller that waits
for each answer).

Set-up makes the matrix on the host from the seed, and the random draws
the call would make (the stacked RP matrices `rM` and the testlog probe)
on the card, matched to the genes the call keeps; then it warms up with
`params.warm_calls` calls. Every call of the window gets the same inputs,
so each answer is the same: the check holds a sample of the window's
answers, drawn from the seed with the last one in it, against the plain
reference run once on the same inputs.

params: warm_calls, check_calls, profile_calls, limits.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.data.atlas import seeds, ternary_rp
from perfbench.data.tpm import make
from perfbench.reference import meta
from perfbench.reference.meta import allc_pad, nc_pad
from perfbench.reference import cluster
from perfbench.reference.cluster import full_float32, opt_hclust, pearson_distance, project
from perfbench.reference.compare import ari, judge, label_gap, rel_err, worst


class Driver:
    annotations = ()

    def __init__(self, cfg: dict, params: dict, seed: int, dev, spans, control: bool = False):
        self.c, self.p, self.seed, self.dev, self.spans = cfg, params, seed, dev, spans
        self.control = control
        self.answers = []

    def setup(self) -> None:
        c = self.c
        s_data, s_rp, s_perm, s_probe, self.s_check = seeds(self.seed, 5)
        self.X, self.truth = make(c["n_cells"], c["n_genes"], c["n_types"], s_data)
        keep = np.maximum(self.X, 0).sum(axis=0) > 0
        genes, K, p = int(keep.sum()), c["ensize_K"], c["reduced_ndim"]
        self.keep = keep
        self.R = ternary_rp(genes, K * p, s_rp, self.dev)
        g = torch.Generator(device=self.dev)
        g.manual_seed(s_perm)
        from sharp_tpu_torch.core.pipeline import TestlogProbe

        self.probe = TestlogProbe(torch.randperm(c["n_cells"], generator=g, device=self.dev),
                                  ternary_rp(genes, p, s_probe, self.dev))
        if self.control:
            # the program's own lower precision: its float32 products in TF32
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        for _ in range(self.p.get("warm_calls", 2)):
            self._call()

    def _call(self):
        from sharp_tpu_torch import sharp

        c = self.c
        return sharp(self.X, rM=self.R, testlog_probe=self.probe, device=self.dev, ensize_K=c["ensize_K"],
                     reduced_ndim=c["reduced_ndim"], exp_type=c["exp_type"],
                     linkage_backend=c["linkage_backend"], rN_seed=7)

    def solve(self) -> dict:
        res = self._call()
        stages = {r["stage"]: r["seconds"] for r in res.timing["stages"]}
        self.answers.append(dict(labels=res.pred_clusters, viE=res.viE, maxsil=res.per_member_maxsil,
                                 k_per=res.per_member_k))
        return {"cells": int(self.c["n_cells"]), "ensemble_cluster_s": stages.get("ensemble_cluster"),
                "stages": stages}

    def profile_segment(self):
        recs = []
        for _ in range(self.p.get("profile_calls", 10)):
            recs.append(self.solve())
            self.answers.pop()
        return recs

    def layer_context(self) -> dict:
        return {}

    def release(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def reference(self, kind: str = "float32", prefer=None):
        """The plain reference on the call's inputs, its products in the
        precision `kind` -> (labels, mean projection, members' max
        silhouette); `prefer`, an answer of the program, is followed where
        the reference's choices are within rounding of it."""
        c = self.c
        n, K = c["n_cells"], c["ensize_K"]
        X = torch.as_tensor(np.maximum(self.X, 0)[:, self.keep], device=self.dev)
        sub = X[self.probe.perm[: min(100, n)].to(self.dev)]
        Rp = self.probe.R.float()
        Z = torch.stack([project(sub, Rp, 1, False, kind)[0], project(sub, Rp, 1, True, kind)[0]])
        ms = opt_hclust(pearson_distance(Z, kind), Z, minN=2, ncand=39, maxN=40, nc_cap=nc_pad(40) - 1,
                        sil_thre=0.0, height_Ntimes=2.0)["maxsil"]
        log = bool(ms[0] < 0.75 and ms[0] >= 0.95 * ms[1])
        maxN = max(40, -(-n // 5000))
        rc = dict(K=K, rp_kind=kind, mm_kind=kind, minN=2, maxN=maxN, ncand=maxN - 1, nc_cap=nc_pad(maxN) - 1,
                  sil_thre=0.35, height_Ntimes=2.0, sim_width=allc_pad(K, maxN))
        if prefer is not None:
            prefer = {"k_per": prefer["k_per"], "finalC": prefer["labels"]}
        ref = meta.fold(X, self.R.float(), rc, log=log, prefer=prefer)
        return meta.finalize(ref.finalC, merge_tiny=n > 1e4), ref.mean_proj.cpu().numpy(), ref.maxsil

    def check(self, records) -> dict:
        rng = np.random.default_rng(self.s_check)
        cluster.reset_readings()
        n = len(self.answers)
        idx = sorted({n - 1} | set(rng.choice(n, min(self.p.get("check_calls", 4), n), replace=False).tolist()))
        with full_float32():
            labels, viE, maxsil = self.reference(prefer=self.answers[-1])
        picked = [self.answers[i] for i in idx]
        numbers = {
            "label_gap": worst(label_gap(a["labels"], labels) for a in picked),
            "viE_err": worst(rel_err(a["viE"], viE) for a in picked),
            "maxsil_err": worst(float(np.abs(a["maxsil"] - maxsil).max()) for a in picked),
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
                "median_stage_s": stages, "rule_chain": cluster.readings()}
