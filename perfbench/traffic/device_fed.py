"""Traffic `device_fed`: whole solutions of an atlas whose expression is
made on the card, back to back.

A solution runs every fold group of the fold plan through the fold program
(`core.fold.fold_program`; each group made on the card first, its window
closed by the program's last output read back), the host summaries
(`core.large.summaries_to_host`), the per-block sMetaC fuses in one batched
call (`core.large.fuse_blocks`), the global fuse
(`parallel.streaming.global_block_fuse`) and the final labels
(`types.finalize_labels`). Generation lies inside the solution's time.

Set-up makes the RP matrices from the seed (handed in as `R_all`), runs
one fold group and the fuses at the solution's shape buckets (the warm
group's summaries copied, slightly perturbed, to every fold), and keeps
the type means on the card. The check draws a solution from the seed.
It makes every fold of it again and holds each fold's summary (the
centroid sums and the counts of its clusters) against the reference's
projection summed over the fold's own labels; it runs the whole reference
on some folds, drawn from the seed, and holds their labels and
silhouettes against it; then it runs the reference's fuses on the
program's fold summaries, so checked, and holds the block and final
labels against them.

params: group (folds a fold-program call), check_folds, limits.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.data.atlas import AtlasData, block_sizes, fold_plan, pad_rows, seeds, ternary_rp
from perfbench.reference import meta
from perfbench.reference.meta import allc_pad, nc_pad
from perfbench.reference import cluster
from perfbench.reference.cluster import full_float32, project
from perfbench.reference.compare import ari, judge, label_gap, rel_err, worst


# the control's RP operands: the precision just below the stated one
CONTROL_DTYPE = {"bfloat16": "float8_e4m3fn", "float16": "float8_e4m3fn"}


class Driver:
    annotations = ("perfbench.rp_product",)

    def __init__(self, cfg: dict, params: dict, seed: int, dev, spans, control: bool = False):
        self.c, self.p, self.seed, self.dev, self.spans = cfg, params, seed, dev, spans
        self.control = control
        self.solutions = []

    # --- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from sharp_tpu_torch.config import resolve_config
        from sharp_tpu_torch.core.fold import fold_static_args

        c = self.c
        self.blocks = block_sizes(c["n_cells"], c["block_cells"])
        self.plan = fold_plan(self.blocks, c["partition_ncells"])
        self.B = pad_rows(max(sz for _, sz in self.plan))
        self.scfg = resolve_config(
            c["n_cells"], c["n_genes"], ensize_K=c["ensize_K"], reduced_ndim=c["reduced_ndim"],
            partition_ncells=c["partition_ncells"], dtype_compute=c["dtype_compute"],
            forview=c["forview"], linkage_backend=c["linkage_backend"], rN_seed=7,
        )
        self.static = fold_static_args(self.scfg)
        s_data, s_rp, self.s_check = seeds(self.seed, 3)
        self.data = AtlasData(c["n_genes"], c["n_types"], self.B, s_data, self.dev)
        K, p = c["ensize_K"], c["reduced_ndim"]
        self.R_ref = ternary_rp(c["n_genes"], K * p, s_rp, self.dev, getattr(torch, c["dtype_compute"]))
        self.R = self.R_ref if not self.control else ternary_rp(
            c["n_genes"], K * p, s_rp, self.dev, getattr(torch, CONTROL_DTYPE[c["dtype_compute"]]))
        self.group = min(self.p.get("group", 16), len(self.plan))
        warm = self._fold_group(0)
        rng = np.random.default_rng(self.s_check)
        fake = []
        for b, bn in enumerate(self.blocks):
            folds = [sz for bb, sz in self.plan if bb == b]
            fake.append([self._perturbed(warm[i % len(warm)], rng) for i in range(len(folds))])
        self._fuse(fake)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    @staticmethod
    def _perturbed(fr: dict, rng) -> dict:
        out = dict(fr)
        out["cent_sum"] = fr["cent_sum"] * (1.0 + 1e-3 * rng.standard_normal(fr["cent_sum"].shape)).astype(np.float32)
        return out

    # --- one solution -----------------------------------------------------------

    def _fold_group(self, g0: int):
        from sharp_tpu_torch.core.fold import fold_program
        from sharp_tpu_torch.core.large import summaries_to_host

        gplan = self.plan[g0 : g0 + self.group]
        sizes = [sz for _, sz in gplan]
        lanes = sizes + [sizes[0]] * (self.group - len(sizes))
        with self.spans("datagen", sync=True):
            Xg = self.data.group(g0, self.group)
            masks = torch.arange(self.B, device=self.dev)[None, :] < torch.tensor(lanes, device=self.dev)[:, None]
        with self.spans("fold_pass"):
            out = fold_program(Xg, masks, lanes, self.R, True, None, **self.static)
            out.n_meta.cpu()
        del Xg, masks
        return summaries_to_host(out, sizes + [0] * (self.group - len(sizes)), False)

    def _fuse(self, block_frs):
        from sharp_tpu_torch.core.large import fuse_blocks
        from sharp_tpu_torch.parallel.streaming import global_block_fuse
        from sharp_tpu_torch.types import finalize_labels

        with self.spans("fuse.blocks"):
            fused = fuse_blocks(block_frs, self.scfg, group=len(block_frs), device=self.dev)
        summaries, block_labels = [], []
        for fres in fused:
            uniq = np.unique(fres.labels)
            summaries.append((fres.cents[uniq], fres.counts[uniq]))
            block_labels.append(np.searchsorted(uniq, fres.labels))
        with self.spans("fuse.global"):
            tf, remap, offsets, _, _ = global_block_fuse(summaries, self.scfg, self.dev)
        parts = [remap[tf[offsets[b] + block_labels[b]]] for b in range(len(summaries))]
        return block_labels, finalize_labels(np.concatenate(parts).astype(np.int32), merge_tiny=True)

    def solve(self) -> dict:
        from sharp_tpu_torch.ops import linkage_cuda

        before = dict(linkage_cuda.LAUNCHES)
        block_frs = [[] for _ in self.blocks]
        for g0 in range(0, len(self.plan), self.group):
            frs = self._fold_group(g0)
            for gi, (b, _) in enumerate(self.plan[g0 : g0 + self.group]):
                block_frs[b].append(frs[gi])
        block_labels, labels = self._fuse(block_frs)
        self.solutions.append(dict(block_frs=block_frs, block_labels=block_labels, labels=labels))
        launches = {k: v - before[k] for k, v in linkage_cuda.LAUNCHES.items()}
        return {"cells": int(self.c["n_cells"]), "launches": launches}

    # --- the traced segment -------------------------------------------------------

    def profile_segment(self):
        """One solution with a span around each RP product of the fold program."""
        import sharp_tpu_torch.core.block as block

        inner = block.rp_project_ensemble

        def rp_span(*a, **k):
            with torch.profiler.record_function("perfbench.rp_product"):
                return inner(*a, **k)

        block.rp_project_ensemble = rp_span
        self.spans.solution = -1            # the window's readers skip this solution
        try:
            rec = self.solve()
        finally:
            block.rp_project_ensemble = inner
        self.solutions.pop()
        return [rec]

    def layer_context(self) -> dict:
        c = self.c
        real = sum(sz for _, sz in self.plan)
        kp = c["ensize_K"] * c["reduced_ndim"]
        width = torch.tensor([], dtype=getattr(torch, c["dtype_compute"])).element_size()
        return {"rp_work": {"flops": 2.0 * real * c["n_genes"] * kp,
                            "bytes": real * c["n_genes"] * 4 + c["n_genes"] * kp * width + real * kp * 4,
                            "flops_key": {"bfloat16": "bf16_flops", "float16": "fp16_flops"}.get(
                                c["dtype_compute"], "fp32_flops")}}

    def release(self) -> None:
        """Drop the program's device state before the reference runs."""
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check ----------------------------------------------------------------

    def ref_config(self) -> dict:
        s = self.scfg
        return dict(K=s.ensize_K, rp_kind=self.c["dtype_compute"], minN=s.minN_cluster,
                    maxN=min(s.maxN_cluster, 40), ncand=min(s.maxN_cluster, 40) - s.minN_cluster + 1,
                    nc_cap=nc_pad(s.maxN_cluster) - 1, sil_thre=s.sil_thre, height_Ntimes=s.height_Ntimes,
                    sim_width=allc_pad(s.ensize_K, s.maxN_cluster), n_cells=s.n_cells,
                    maxN_cluster=s.maxN_cluster, nc_pad=nc_pad(s.maxN_cluster))

    def check(self, records) -> dict:
        rng = np.random.default_rng(self.s_check)
        cluster.reset_readings()
        sol = self.solutions[int(rng.integers(len(self.solutions)))]
        T = len(self.plan)
        n_check = min(self.p.get("check_folds", 8), T)
        folds = sorted({T - 1} | set(rng.choice(T - 1, n_check - 1, replace=False).tolist())) if T > 1 else [0]
        rc = self.ref_config()
        first = {}
        for t, (b, _) in enumerate(self.plan):
            first.setdefault(b, t)
        R = self.R_ref.float()
        nums = {"fold_label_gap": [], "centroid_err": [], "count_gap": [], "maxsil_err": []}
        Xf = torch.empty((self.B, self.c["n_genes"]), device=self.dev)
        with full_float32():
            for t, (b, sz) in enumerate(self.plan):
                # every fold's summary, the fuses' input: sums of the
                # reference's mean projection over the program's own labels
                fr = sol["block_frs"][b][t - first[b]]
                self.data.fold_into(t, Xf)
                proj = project(Xf[:sz], R, rc["K"], True, rc["rp_kind"]).mean(dim=0)
                lab = torch.as_tensor(fr["finalC"], dtype=torch.long, device=self.dev)
                width = fr["cent_sum"].shape[0]
                sums = torch.zeros((width, proj.shape[1]), dtype=torch.float64, device=self.dev)
                sums.index_add_(0, lab, proj.double())
                nums["centroid_err"].append(rel_err(fr["cent_sum"], sums.cpu().numpy()))
                cnt = torch.bincount(lab, minlength=width).cpu().numpy()
                nums["count_gap"].append(float(np.abs(np.asarray(fr["counts"], np.float64) - cnt).max()))
                del proj
            for t in folds:
                b, sz = self.plan[t]
                self.data.fold_into(t, Xf)
                fr = sol["block_frs"][b][t - first[b]]
                ref = meta.fold(Xf[:sz], R, rc, prefer=fr)
                nums["fold_label_gap"].append(label_gap(fr["finalC"], ref.finalC))
                nums["maxsil_err"].append(float(np.abs(fr["maxsil"] - ref.maxsil).max()))
            del Xf
            ref_blocks = [meta.fuse_block(frs, rc, self.dev, prefer=lab)
                          for frs, lab in zip(sol["block_frs"], sol["block_labels"])]
            ref_final = meta.global_fuse(ref_blocks, rc, self.dev, prefer=sol["labels"])
        numbers = {k: worst(v) for k, v in nums.items()}
        numbers["block_label_gap"] = worst(label_gap(p, r.labels) for p, r in zip(sol["block_labels"], ref_blocks))
        numbers["final_label_gap"] = label_gap(sol["labels"], ref_final)
        self._checked = (sol, folds)
        return judge(numbers, self.p["limits"])

    def info(self, records) -> dict:
        sol, folds = getattr(self, "_checked", (self.solutions[-1] if self.solutions else None, []))
        if sol is None:
            return {}
        truth = np.concatenate([self.data.planted(t)[:sz].cpu().numpy() for t, (_, sz) in enumerate(self.plan)])
        return {"checked_folds": folds, "ari_vs_planted": ari(truth, sol["labels"]),
                "n_clusters": int(len(np.unique(sol["labels"]))), "solutions": len(self.solutions),
                "rule_chain": cluster.readings()}
