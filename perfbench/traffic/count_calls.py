"""Traffic `count_calls`: closed-loop calls of `sharp_tpu_torch.sharp` on
one host-resident matrix of UMI counts at the API's defaults, back to
back (one caller that waits for each answer): `repeat_calls`' calls and
window on a 10x-like sample, which takes the count path (the clamp, the
all-zero-gene drop and CPM on the host, `exp_type="count"`).

Set-up makes the sample on the card from the seed (`data/umi.py`) and
copies it once into host memory as a dense float32 array; it draws the
stacked RP matrices `rM` and the testlog probe on the card, matched to the
genes the call's prep keeps, and warms up with `params.warm_calls` calls,
after which it holds the knobs the call resolved (`SharpResult.paras`) to
the ones the configuration states. Every call gets the same inputs, so
each answer is the same: the check runs the plain reference of the small
tier from the raw matrix (`reference/small.py`) once and holds the last
answer and a sample of earlier ones, drawn from the seed, against it:
the labels, each member's k, `viE` and the members' max silhouettes.

params: warm_calls, check_calls, profile_calls, limits.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.data import umi
from perfbench.data.atlas import seeds, ternary_rp
from perfbench.reference import cluster, small
from perfbench.reference.cluster import full_float32
from perfbench.reference.compare import judge, label_gap, rel_err, worst
from perfbench.traffic.repeat_calls import Driver as RepeatCalls

# knobs the configuration states, as `SharpResult.paras` names them
STATED = ("ensize_K", "reduced_ndim", "maxN_cluster", "prep", "exp_type", "linkage_backend")


class Driver(RepeatCalls):
    def setup(self) -> None:
        c = self.c
        s_data, s_rp, s_perm, s_probe, self.s_check = seeds(self.seed, 5)
        sample = umi.make(c["n_cells"], c["n_genes"], c["type_shares"], s_data, self.dev, **c["umi"])
        self.X, self.truth, self.keep = sample
        genes, K, p = int(self.keep.sum()), c["ensize_K"], c["reduced_ndim"]
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
            res = self._call()
        wrong = {k: (res.paras[k], c[k]) for k in STATED if res.paras[k] != c[k]}
        if wrong:
            raise ValueError(f"the call resolved other knobs than the configuration states: {wrong}")

    def reference(self, kind: str = "float32", prefer=None) -> small.SmallRef:
        """The plain reference of the small tier on the call's raw matrix,
        its products in the precision `kind`; `prefer`, an answer of the
        program, is followed where the reference's choices are within
        rounding of it."""
        c = self.c
        return small.sharp_small(torch.as_tensor(self.X, device=self.dev), self.R, self.probe.perm, self.probe.R,
                                 c["ensize_K"], c["reduced_ndim"], c["exp_type"], kind=kind, prefer=prefer)

    def check(self, records) -> dict:
        rng = np.random.default_rng(self.s_check)
        cluster.reset_readings()
        n = len(self.answers)
        idx = sorted({n - 1} | set(rng.choice(n, min(self.p.get("check_calls", 3), n), replace=False).tolist()))
        last = self.answers[-1]
        with full_float32():
            ref = self.reference(prefer={"k_per": last["k_per"], "labels": last["labels"]})
        picked = [self.answers[i] for i in idx]
        numbers = {
            "label_gap": worst(label_gap(a["labels"], ref.labels) for a in picked),
            "k_gap": worst(float(np.abs(a["k_per"] - ref.k_per).max()) for a in picked),
            "viE_err": worst(rel_err(a["viE"], ref.viE) for a in picked),
            "maxsil_err": worst(float(np.abs(a["maxsil"] - ref.maxsil).max()) for a in picked),
        }
        self._checked, self._ref = idx, ref
        return judge(numbers, self.p["limits"])

    def info(self, records) -> dict:
        out = super().info(records)
        if out:
            ref = getattr(self, "_ref", None)
            out.update(genes_kept=int(self.keep.sum()), host_matrix_bytes=int(self.X.nbytes),
                       detected_genes_per_cell=float(np.median((self.X > 0).sum(axis=1))),
                       umis_per_cell=float(np.median(self.X.sum(axis=1))),
                       type_sizes=np.bincount(self.truth).tolist(),
                       reference_log=None if ref is None else ref.log)
        return out
