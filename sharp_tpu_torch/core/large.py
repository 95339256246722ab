"""The large-data tier: fold partitioning + per-fold ensemble + per-fold
wMetaC + global sMetaC.

Counterpart of `sharp_tpu/core/large.py`, mirroring SHARP_large
(R/SHARP.R:478-851): random cell reshuffle (skipped at >= 1e5 cells,
:493-507), ~partition.ncells folds with last-two-fold rebalancing
(:513-536), K shared RP matrices (:541-549), per-(k, t) project + cluster
(:554-618), per-fold wMetaC (:692-731), cross-fold sMetaC over centroids in
mean-RP space (:747-773), un-permute + tiny-cluster merge + relabel
(:775-843).

The folds run in groups through `parallel/sharded.process_folds`, over a
mesh of devices when `n_devices > 1`; cross-fold communication is
exactly the per-fold summaries (labels, centroid stats, mean-RP features),
O(clusters x p). `fuse_folds` fuses one block's folds (`sharp()`);
`fuse_blocks` fuses many blocks' at once (`sharp_unlimited`). The
host-side helpers here are numpy copies of the JAX package's (that module
imports jax).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from sharp_tpu_torch.config import SharpConfig, pad_dim
from sharp_tpu_torch.types import SharpResult, finalize_labels
from sharp_tpu_torch.core.pipeline import TestlogProbe, resolve_log_transform
from sharp_tpu_torch.core.smetac import smetac, smetac_range
from sharp_tpu_torch.ops.rp import ensemble_rp_matrix
from sharp_tpu_torch.utils.prng import shuffle_generator
from sharp_tpu_torch.utils.timers import StageTimer, host_read, log, span, sub


def fold_sizes(n: int, partition_ncells: int) -> List[int]:
    """Fold partition with last-two-fold rebalancing (R/SHARP.R:513-536)."""
    if n <= partition_ncells:
        return [n]
    T = int(np.ceil(n / partition_ncells))
    sizes = [partition_ncells] * (T - 1)
    rem = n - partition_ncells * (T - 1)
    if T >= 2 and rem < partition_ncells:
        tot = partition_ncells + rem
        half = tot // 2
        sizes = sizes[:-1] + [tot - half, half]
    else:
        sizes = sizes + [rem]
    if sum(sizes) != n:
        raise AssertionError(f"fold sizes {sizes} do not add up to {n}")
    return sizes


def _host(x) -> np.ndarray:
    return np.asarray(host_read(x, "large.summaries") if isinstance(x, torch.Tensor) else x)


def summary_to_host(s, n_fold: int, forview: bool = True) -> dict:
    """One fold's FoldSummary (device tensors or host arrays) -> host dict,
    truncated to the fold's n_fold real cells. `forview=False` skips the
    O(B x p) planes `mean_proj` and `x0`, which only the view needs."""
    out = {
        "finalC": _host(s.finalC)[:n_fold],
        "n_meta": int(_host(s.n_meta)),
        "cent_sum": _host(s.cent_sum),
        "counts": _host(s.counts),
        "k_per": _host(s.k_per),
        "maxsil": _host(s.maxsil),
        "overflow": bool(_host(s.overflow)),
    }
    if forview:
        out["mean_proj"] = _host(s.mean_proj)[:n_fold]
        out["x0"] = _host(s.x0)[:n_fold]
    return out


_SUMMARY_FIELDS = (
    "finalC", "n_meta", "cent_sum", "counts", "k_per", "maxsil", "overflow"
)


def summaries_to_host(out, sizes, forview: bool) -> List[dict]:
    """A batched FoldSummary (leading fold axis) -> per-fold host dicts,
    one copy to the host per field."""
    names = _SUMMARY_FIELDS + (("mean_proj", "x0") if forview else ())
    with span("summaries_to_host"):
        host = {k: _host(getattr(out, k)) for k in names}
        return [
            summary_to_host(SimpleNamespace(**{k: v[gi] for k, v in host.items()}), int(sz), forview)
            for gi, sz in enumerate(sizes)
        ]


def process_fold(
    X_fold: np.ndarray,
    n_fold: int,
    block_pad: int,
    R_all: torch.Tensor,
    cfg: SharpConfig,
    logf: bool,
    *,
    device="cuda",
) -> dict:
    """One fold: ensemble cluster + wMetaC, as a group of one through the
    fold program, with `indN_cluster` kept. Returns its host summary."""
    from sharp_tpu_torch.core.fold import fold_program, fold_static_args

    dev = torch.device(device)
    Xp = torch.zeros((block_pad, X_fold.shape[1]), dtype=torch.float32)
    Xp[:n_fold] = torch.as_tensor(np.asarray(X_fold, np.float32)[:n_fold])
    mask = torch.arange(block_pad) < n_fold
    s = fold_program(
        Xp.to(dev), mask.to(dev), n_fold, R_all.to(dev), logf, cfg.indN_cluster,
        has_indN=cfg.indN_cluster is not None, **fold_static_args(cfg),
    )
    return summary_to_host(s, n_fold, forview=cfg.forview)


class FuseResult(NamedTuple):
    """Result of the cross-fold sMetaC fuse. `labels` index the columns of
    `x0` / rows of `cents`; the last slot W - 1 is the reserved garbage
    slot (W = meta_nc_pad when T > 1, the fold's nc_pad when T == 1)."""

    labels: np.ndarray        # (n_total,) meta label per cell, fold order
    n_final: int
    x0: Optional[np.ndarray]  # (n_total, W) vis matrix; None when folds carry no x0
    cents: np.ndarray         # (W, p) per-meta-cluster centroid in mean-RP space
    counts: np.ndarray        # (W,) cells per meta cluster


class _PreparedBlock(NamedTuple):
    """Host-side compaction of one block's fold summaries for sMetaC."""

    t_idx: np.ndarray      # (NC,) fold index per global (fold, cluster) id
    c_idx: np.ndarray      # (NC,) fold-local cluster id
    cent_sums: np.ndarray  # (NC, p) per-cluster centroid SUMS
    counts: np.ndarray     # (NC,) cells per cluster
    cents: np.ndarray      # (NC, p) centroids (sums / counts)
    NC: int
    NC_pad: int
    minN: int
    maxN: int
    ncand: int
    meta_nc_pad: int


def _smetac_block_shapes(cfg: SharpConfig, NC: int, NC_pad: int):
    """sMetaC shapes for one block: `ncand` and `meta_nc_pad` are sized from
    the padded cluster budget NC_pad; candidates above the block's maxN are
    masked invalid inside opt_hclust, so the selection is unchanged."""
    minN, eff_maxN = smetac_range(cfg.n_cells, cfg.minN_cluster, cfg.maxN_cluster, NC)
    maxN = min(eff_maxN, NC - 1) if NC > 1 else 1
    # a block with fewer clusters than the >= 1e6 widened minN floor would
    # have no valid candidate; clamp the floor so one survives
    if maxN < minN:
        minN = max(2, maxN)
    budget = min(eff_maxN, NC_pad)
    ncand = max(budget - minN + 1, 1)
    meta_nc_pad = ((budget + 9) // 8) * 8
    return minN, maxN, ncand, meta_nc_pad


def _prepare_block(fold_results: List[dict], cfg: SharpConfig) -> _PreparedBlock:
    """Compact nonzero (fold, cluster) slots into dense global ids,
    fold-major, cluster id ascending within a fold."""
    nc_pad = cfg.nc_pad
    counts_all = np.stack([fr["counts"][: nc_pad - 1] for fr in fold_results])
    t_idx, c_idx = np.nonzero(counts_all > 0)
    NC = len(t_idx)
    cent_all = np.stack([fr["cent_sum"] for fr in fold_results])
    cent_sums = cent_all[t_idx, c_idx].astype(np.float32)
    counts = counts_all[t_idx, c_idx].astype(np.float32)
    cents = cent_sums / np.maximum(counts, 1.0)[:, None]
    NC_pad = pad_dim(max(NC, 8))
    minN, maxN, ncand, meta_nc_pad = _smetac_block_shapes(cfg, NC, NC_pad)
    return _PreparedBlock(
        t_idx=t_idx, c_idx=c_idx, cent_sums=cent_sums, counts=counts,
        cents=cents, NC=NC, NC_pad=NC_pad, minN=minN, maxN=maxN,
        ncand=ncand, meta_nc_pad=meta_nc_pad,
    )


def _finish_block(
    fold_results: List[dict],
    cfg: SharpConfig,
    prep: _PreparedBlock,
    tf: np.ndarray,
    n_final: int,
) -> FuseResult:
    """Map cells through the sMetaC table and aggregate meta centroids."""
    T = len(fold_results)
    nc_pad = cfg.nc_pad
    meta_nc_pad = prep.meta_nc_pad
    has_x0 = "x0" in fold_results[0]
    p = prep.cent_sums.shape[1]
    tf_real = tf[: prep.NC]

    meta_cent_sum = np.zeros((meta_nc_pad, p), np.float32)
    meta_counts = np.zeros(meta_nc_pad, np.float32)
    np.add.at(meta_cent_sum, tf_real, prep.cent_sums)
    np.add.at(meta_counts, tf_real, prep.counts)
    meta_cents = meta_cent_sum / np.maximum(meta_counts, 1.0)[:, None]

    # per-fold local cluster id -> meta label (garbage slot for empty slots)
    local_map = np.full((T, nc_pad), meta_nc_pad - 1, np.int32)
    local_map[prep.t_idx, prep.c_idx] = tf_real

    labels_parts = []
    x0_parts = []
    for t, fr in enumerate(fold_results):
        labels_parts.append(local_map[t][fr["finalC"]])
        if has_x0:
            # x0 columns remapped (summed) onto the global meta clusters
            M = np.zeros((nc_pad, meta_nc_pad), np.float32)
            cc = np.nonzero(local_map[t] < meta_nc_pad - 1)[0]
            M[cc, local_map[t][cc]] = 1.0
            x0_parts.append(fr["x0"] @ M)

    return FuseResult(
        labels=np.concatenate(labels_parts),
        n_final=int(n_final),
        x0=np.concatenate(x0_parts, axis=0) if has_x0 else None,
        cents=meta_cents,
        counts=meta_counts,
    )


def _warn_overflow(fold_results: List[dict]) -> None:
    n_over = sum(1 for fr in fold_results if fr.get("overflow"))
    if n_over:
        log(
            f"WARNING: wMetaC cluster budget (allc_pad) overflowed in "
            f"{n_over}/{len(fold_results)} folds — consensus is degraded; raise "
            f"maxN_cluster/ensize_K headroom or partition into smaller folds"
        )


def _single_fold_result(fr: dict) -> FuseResult:
    """T == 1: the fold-local consensus IS the block meta clustering."""
    cents1 = fr["cent_sum"] / np.maximum(fr["counts"], 1.0)[:, None]
    return FuseResult(
        labels=fr["finalC"],
        n_final=fr["n_meta"],
        x0=fr.get("x0"),
        cents=cents1.astype(np.float32),
        counts=fr["counts"].astype(np.float32),
    )


def fuse_folds(
    fold_results: List[dict],
    cfg: SharpConfig,
    n_total: Optional[int] = None,
    finalN_cluster: Optional[int] = None,
    *,
    device="cuda",
) -> FuseResult:
    """Global sMetaC over per-fold cluster summaries (R/SHARP.R:747-773),
    run on `device`. `n_total` (the block's cells) is accepted and unused,
    as in the JAX package."""
    return fuse_blocks([fold_results], cfg, finalN_cluster, device=device)[0]


def fuse_blocks(
    blocks_fold_results: List[List[dict]],
    cfg: SharpConfig,
    finalN_cluster: Optional[int] = None,
    group: int = 8,
    *,
    device="cuda",
) -> List[FuseResult]:
    """Per-block sMetaC fuses, batched: the same results as
    `[fuse_folds(frs, cfg) for frs in blocks_fold_results]`, with the
    blocks that share a shape key (NC_pad, minN, ncand, meta_nc_pad) fused
    in one `smetac` call (the JAX package's vmapped fuse,
    `sharp_tpu/core/large.py:328-418`), at most `group` blocks a call: one
    serial Ward launch and one cut replay a call. A block of one fold is
    its own fuse (`_single_fold_result`)."""
    with span("fuse_blocks"):
        results: List[Optional[FuseResult]] = [None] * len(blocks_fold_results)
        preps: List[Optional[_PreparedBlock]] = [None] * len(blocks_fold_results)
        by_shape = {}
        with sub("prepare"):
            for bi, frs in enumerate(blocks_fold_results):
                _warn_overflow(frs)
                if len(frs) == 1:
                    results[bi] = _single_fold_result(frs[0])
                    continue
                prep = preps[bi] = _prepare_block(frs, cfg)
                by_shape.setdefault((prep.NC_pad, prep.minN, prep.ncand, prep.meta_nc_pad), []).append(bi)
        chunks = [(key, idxs[g0 : g0 + group]) for key, idxs in by_shape.items() for g0 in range(0, len(idxs), group)]
        for (NC_pad, minN, ncand, meta_nc_pad), idxs in chunks:
            with sub("smetac"):
                bucket = [preps[bi] for bi in idxs]
                cents = np.zeros((len(bucket), NC_pad, bucket[0].cents.shape[1]), np.float32)
                for b, pr in enumerate(bucket):
                    cents[b, : pr.NC] = pr.cents
                NCs = np.asarray([pr.NC for pr in bucket], np.int32)
                valid = np.arange(NC_pad)[None, :] < NCs[:, None]
                sres = smetac(
                    torch.from_numpy(cents).to(device), torch.from_numpy(valid).to(device), NCs,
                    [pr.maxN for pr in bucket],
                    minN=minN, ncand=ncand, meta_nc_pad=meta_nc_pad,
                    sil_thre=cfg.sil_thre, height_Ntimes=cfg.height_Ntimes,
                    finalN_cluster=finalN_cluster,
                    hmethod=cfg.hmethod, linkage_backend=cfg.linkage_backend,
                )
                tfs = host_read(sres.tf, "large.fuse_tf").numpy()
                n_finals = host_read(sres.n_final, "large.fuse_n_final").numpy()
            with sub("finish"):
                for b, bi in enumerate(idxs):
                    results[bi] = _finish_block(blocks_fold_results[bi], cfg, preps[bi], tfs[b], int(n_finals[b]))
        return results


def sharp_large(
    X: np.ndarray,
    cfg: SharpConfig,
    rN_seed: int,
    device,
    timer: Optional[StageTimer] = None,
    R_all: Optional[torch.Tensor] = None,
    testlog_probe: Optional[TestlogProbe] = None,
    shuffle_perm: Optional[torch.Tensor] = None,
) -> SharpResult:
    """Large-data tier ~ SHARP_large (R/SHARP.R:478-851) on `device`.

    `R_all` injects the stacked RP matrices (the reference's `rM`),
    `testlog_probe` the testlog draws and `shuffle_perm` the cell
    permutation (`sharp_tpu_torch.carry`), which must hold each of 0..n-1
    once; by default all are drawn from `rN_seed` on `device`.

    `timing["fold_pass"]` holds the dense feed's host seconds over the
    call's fold groups (`slice_s`: the gather, `transfer_s`: the copy's
    call), read with no synchronise.
    """
    from sharp_tpu_torch.parallel.mesh import resolve_mesh
    from sharp_tpu_torch.parallel.sharded import FEED_KEYS, process_folds

    timer = timer or StageTimer("large")
    n, genes = X.shape
    dev = torch.device(device)

    with timer.stage("log_decision"):
        logf = resolve_log_transform(
            torch.from_numpy(X), cfg, rN_seed, probe=testlog_probe, device=dev
        )

    with timer.stage("permute_partition"):
        if shuffle_perm is not None:
            perm = np.asarray(torch.as_tensor(shuffle_perm).cpu(), dtype=np.int64)
            if perm.shape != (n,):
                raise ValueError(f"shuffle_perm has shape {perm.shape}, expected ({n},)")
            # a repeated or out-of-range index would cluster the wrong cells
            if perm.min() < 0 or perm.max() >= n or (np.bincount(perm, minlength=n) != 1).any():
                raise ValueError(f"shuffle_perm is not a permutation of 0..{n - 1}")
        elif n < 1e5:
            gen = shuffle_generator(rN_seed, dev)
            perm = host_read(torch.randperm(n, generator=gen, device=dev), "large.perm").numpy()
        else:
            perm = np.arange(n)
        sizes = fold_sizes(n, cfg.partition_ncells)
        T = len(sizes)
        block_pad = pad_dim(max(sizes))
        log(f"large path: {n} cells -> {T} folds, block_pad={block_pad}")

    with timer.stage("rp_setup"):
        dtype = getattr(torch, cfg.dtype_compute)
        if R_all is None:
            R_all = ensemble_rp_matrix(
                rN_seed, cfg.ensize_K, genes, cfg.reduced_ndim, dtype=dtype, device=dev
            )
        else:
            R_all = R_all.to(dev, dtype)

    feed = dict.fromkeys(FEED_KEYS, 0.0)
    with timer.stage("fold_ensemble"):
        fold_results = process_folds(X, sizes, block_pad, R_all, cfg, logf, dev, resolve_mesh(cfg, dev), rows=perm,
                                     feed=feed)

    with timer.stage("smetac"):
        fres = fuse_folds(
            fold_results, cfg, n_total=n, finalN_cluster=cfg.N_cluster, device=dev
        )
        raw_labels, x0 = fres.labels, fres.x0

    with timer.stage("finalize"):
        unperm_labels = np.empty(n, np.int32)
        unperm_labels[perm] = raw_labels
        x0_u = None
        if x0 is not None:
            x0_u = np.empty_like(x0)
            x0_u[perm] = x0
        viE = None
        folds_per_cell = np.empty(n, np.int32)
        if cfg.forview:
            viE = np.empty((n, cfg.reduced_ndim), np.float32)
        off = 0
        for t, sz in enumerate(sizes):
            folds_per_cell[perm[off : off + sz]] = t
            if viE is not None:
                viE[perm[off : off + sz]] = fold_results[t]["mean_proj"]
            off += sz
        merge_tiny = cfg.N_cluster is None and n > 1e4
        labels = finalize_labels(unperm_labels, merge_tiny=merge_tiny)
        vals, counts = np.unique(labels, return_counts=True)

    return SharpResult(
        pred_clusters=labels,
        N_pred_cluster=len(vals),
        unique_pred_clusters=[int(v) for v in vals],
        distr_pred_clusters={int(v): int(c) for v, c in zip(vals, counts)},
        viE=viE,
        x0=x0_u if cfg.forview else None,
        paras=cfg.as_dict(),
        timing={**timer.as_dict(), "fold_pass": feed},
        per_member_k=np.stack([fr["k_per"] for fr in fold_results]),
        per_member_maxsil=np.stack([fr["maxsil"] for fr in fold_results]),
        folds=folds_per_cell,
    )
