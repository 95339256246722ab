"""Traffic `unlimited_calls`: closed-loop calls of
`sharp_tpu_torch.sharp_unlimited` on an atlas held as a list of scipy CSR
blocks in host memory, at its defaults, back to back (one caller
that waits for each answer).

Set-up makes the blocks on the card from the seed (`data/csr_atlas.py`,
`block_cells` cells a block, the remainder joined to the last) and copies
each into host CSR once; it draws the K stacked RP matrices every block
shares on the card (`data/atlas.ternary_rp`, float32), handed in through
`rM`. The call passes nothing else but the device, so the sparse feed and
every knob are `sharp_unlimited`'s defaults for the atlas's size; the
configuration's `knobs`, for tests at small sizes only, are passed as they
are. A program whose `sharp_unlimited` takes no `rM` is refused before any
data is made. After the warm-up calls set-up holds the resolved knobs
(`SharpResult.paras`) to the ones the configuration states.

Every call gets the same inputs. The check draws one answer from the seed
and holds it to the plain reference (`reference/unlimited.py`): the fold
partition; every fold's summary (its centroid sums and counts) against the
reference's projection of the fold densified from the CSR, summed over
the program's own fold labels; some folds, drawn from the seed and always
the last, through the whole reference (consensus, each member's k and
silhouette); the reference's block fuses on the program's fold summaries,
so checked, and its global fuse and relabel.

params: warm_calls, profile_calls, check_folds, limits.
"""

from __future__ import annotations

import inspect
import resource

import numpy as np
import torch

from perfbench.data.atlas import block_sizes, fold_sizes, seeds, ternary_rp
from perfbench.data.csr_atlas import CsrAtlas
from perfbench.reference import cluster, large, meta
from perfbench.reference import unlimited as ref_unlimited
from perfbench.reference.cluster import full_float32, project
from perfbench.reference.compare import ari, judge, label_gap, rel_err, worst

# knobs the configuration states, as `SharpResult.paras` names them
STATED = ("ensize_K", "reduced_ndim", "partition_ncells", "maxN_cluster", "dtype_compute", "forview",
          "linkage_backend")
# the program's tracer counts of the sparse feed, kept from the profiled call
FEED_COUNTS = ("feed.nnz", "feed.wire_bytes", "feed.wire_pinned_bytes", "feed.dense_bytes")


def _mem_available_gib():
    """The host's MemAvailable, GiB (None where it cannot be read)."""
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return None


def _tracer_sums() -> dict:
    try:
        from sharp_tpu_torch.utils.timers import snapshot
    except ImportError:
        return {}
    return snapshot()["sums"]


class Driver:
    annotations = ()

    def __init__(self, cfg: dict, params: dict, seed: int, dev, spans, control: bool = False):
        self.c, self.p, self.seed, self.dev, self.spans = cfg, params, seed, dev, spans
        self.control = control
        self.answers = []
        self.feed_counts = {}

    def setup(self) -> None:
        from sharp_tpu_torch import sharp_unlimited

        if "rM" not in inspect.signature(sharp_unlimited).parameters:
            raise TypeError("the program's sharp_unlimited() takes no rM: the shared RP matrices cannot be handed in")
        c = self.c
        self.mem_available_gib = _mem_available_gib()
        s_data, s_rp, self.s_check = seeds(self.seed, 3)
        data = CsrAtlas(c["n_genes"], c["n_types"], c["nnz_per_cell"], s_data, self.dev)
        self.sizes = block_sizes(c["n_cells"], c["block_cells"])
        self.blocks, truth = [], []
        for b, n in enumerate(self.sizes):
            X, y = data.block(b, n)
            self.blocks.append(X)
            truth.append(y)
        self.truth = np.concatenate(truth)
        del data
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        self.R = ternary_rp(c["n_genes"], c["ensize_K"] * c["reduced_ndim"], s_rp, self.dev)
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
        from sharp_tpu_torch import sharp_unlimited

        return sharp_unlimited(self.blocks, rM=self.R, device=self.dev, **self.c.get("knobs", {}))

    def solve(self) -> dict:
        res = self._call()
        stages = {r["stage"]: r["seconds"] for r in res.timing["stages"]}
        feed = res.timing.get("fold_pass") or {}      # empty where the program does not report it
        self.answers.append(dict(labels=res.pred_clusters, folds=res.folds, k_per=res.per_member_k,
                                 maxsil=res.per_member_maxsil, fold_labels=res.fold_labels,
                                 block_labels=res.block_labels, cent_sum=res.fold_cent_sum,
                                 counts=res.fold_counts))
        return {"cells": int(self.c["n_cells"]), "block_pass_s": stages.get("block_pass"),
                "csr_feed_wait_s": feed.get("wait_s"), "stages": stages}

    def profile_segment(self):
        """`profile_calls` calls, the sparse feed's tracer counts of them kept."""
        recs = []
        before = _tracer_sums()
        for _ in range(self.p.get("profile_calls", 1)):
            recs.append(self.solve())
            self.answers.pop()
        after = _tracer_sums()
        self.feed_counts = {k: after[k] - before.get(k, 0) for k in FEED_COUNTS if k in after}
        return recs

    def layer_context(self) -> dict:
        wire = self.feed_counts.get("feed.wire_bytes")
        return {"wire_bytes_per_call": wire / self.p.get("profile_calls", 1) if wire else None}

    def release(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # --- the check ----------------------------------------------------------------

    def plan(self):
        """(block, first row in the block, first cell overall, size) of every
        fold, the ports' contiguous folds of each block in block order."""
        out, cell0 = [], 0
        for b, n in enumerate(self.sizes):
            r0 = 0
            for sz in fold_sizes(n, self.c["partition_ncells"]):
                out.append((b, r0, cell0 + r0, sz))
                r0 += sz
            cell0 += n
        return out

    def check(self, records) -> dict:
        c = self.c
        rng = np.random.default_rng(self.s_check)
        cluster.reset_readings()
        sol = self.answers[int(rng.integers(len(self.answers)))]
        plan = self.plan()
        T = len(plan)
        n_check = min(self.p.get("check_folds", 8), T)
        picked = sorted({T - 1} | set(rng.choice(T - 1, n_check - 1, replace=False).tolist())) if T > 1 else [0]
        K, p = c["ensize_K"], c["reduced_ndim"]
        rc = ref_unlimited.config(c["n_cells"], K, p=p, partition_ncells=c["partition_ncells"],
                                  maxN_cluster=c["maxN_cluster"])
        R = self.R.float()
        ref_folds = np.repeat(np.arange(T, dtype=np.int32), [sz for *_, sz in plan])
        nums = {"centroid_err": [], "count_gap": [], "fold_label_gap": [], "k_gap": [], "maxsil_err": []}
        width = sol["cent_sum"].shape[1]
        with full_float32():
            for t, (b, r0, c0, sz) in enumerate(plan):
                # every fold's summary, the fuses' input: sums of the
                # reference's mean projection over the program's own labels
                X = ref_unlimited.densify(self.blocks[b], r0, r0 + sz, self.dev)
                proj = project(X, R, K, True, "float32").mean(dim=0)
                lab = torch.as_tensor(sol["fold_labels"][c0 : c0 + sz], dtype=torch.long, device=self.dev)
                sums = torch.zeros((width, p), dtype=torch.float64, device=self.dev)
                sums.index_add_(0, lab, proj.double())
                nums["centroid_err"].append(rel_err(sol["cent_sum"][t], sums.cpu().numpy()))
                cnt = torch.bincount(lab, minlength=width).cpu().numpy()
                nums["count_gap"].append(float(np.abs(np.asarray(sol["counts"][t], np.float64) - cnt).max()))
                del X, proj
            for t in picked:
                b, r0, c0, sz = plan[t]
                mine = sol["fold_labels"][c0 : c0 + sz]
                summary, _, k, ms = large.fold(ref_unlimited.densify(self.blocks[b], r0, r0 + sz, self.dev), R, rc,
                                               {"k_per": sol["k_per"][t], "finalC": mine})
                nums["fold_label_gap"].append(label_gap(mine, summary["finalC"]))
                nums["k_gap"].append(float(np.abs(np.asarray(sol["k_per"][t]) - k).max()))
                nums["maxsil_err"].append(float(np.abs(np.asarray(sol["maxsil"][t]) - ms).max()))
            ref_blocks, block_gaps, cell0 = [], [], 0
            for b, n in enumerate(self.sizes):
                frs = [dict(finalC=sol["fold_labels"][c0 : c0 + sz], cent_sum=sol["cent_sum"][t],
                            counts=sol["counts"][t]) for t, (bb, _, c0, sz) in enumerate(plan) if bb == b]
                mine = sol["block_labels"][cell0 : cell0 + n]
                ref_blocks.append(meta.fuse_block(frs, rc, self.dev, prefer=mine))
                block_gaps.append(label_gap(mine, ref_blocks[-1].labels))
                cell0 += n
            ref_final = ref_unlimited.global_fuse(ref_blocks, rc, self.dev, prefer=sol["labels"])
        numbers = {k: worst(v) for k, v in nums.items()}
        numbers["fold_gap"] = float((np.asarray(sol["folds"]) != ref_folds).sum())
        numbers["block_label_gap"] = worst(block_gaps)
        numbers["final_label_gap"] = label_gap(sol["labels"], ref_final)
        self._checked = (sol, picked)
        return judge(numbers, self.p["limits"])

    def info(self, records) -> dict:
        sol, picked = getattr(self, "_checked", (self.answers[-1] if self.answers else None, []))
        if sol is None or not records:
            return {}
        stages = {k: float(np.median([r["stages"][k] for r in records])) for k in records[0]["stages"]}
        host_csr = sum(X.data.nbytes + X.indices.nbytes + X.indptr.nbytes for X in self.blocks)
        return {"checked_folds": picked, "calls": len(self.answers), "ari_vs_planted": ari(self.truth, sol["labels"]),
                "n_clusters": int(len(np.unique(sol["labels"]))), "median_stage_s": stages,
                "host_csr_gib": host_csr / 2**30, "mem_available_gib_before_data": self.mem_available_gib,
                "host_peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
                "feed_counts": self.feed_counts, "rule_chain": cluster.readings()}
