"""Pipeline stages: preprocessing, the testlog decision and the small path.

Counterpart of `sharp_tpu/core/pipeline.py`. The small path (n <
base.ncells) mirrors SHARP_small (R/SHARP.R:339-454): log2 -> K-member RP
ensemble -> per-member Ward + model selection -> wMetaC fusion ->
tiny-cluster merge -> first-occurrence relabel, on one padded block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sharp_tpu_torch.config import SharpConfig, pad_dim
from sharp_tpu_torch.types import SharpResult, finalize_labels
from sharp_tpu_torch.core.block import cluster_block_ensemble
from sharp_tpu_torch.core.fold import _allc_pad
from sharp_tpu_torch.core.wmetac import wmetac
from sharp_tpu_torch.ops.rp import ensemble_rp_matrix, rp_project, ternary_rp_matrix
from sharp_tpu_torch.ops.select import opt_hclust
from sharp_tpu_torch.utils.prng import fixed_generator, testlog_generator
from sharp_tpu_torch.utils.timers import StageTimer, add, host_read, log, span


class TestlogProbe(NamedTuple):
    """The random draws of the testlog decision: a permutation of the cells
    (its first `sncells` entries pick the probe subset) and the fixed-seed
    (genes, p) probe RP matrix."""

    perm: torch.Tensor   # (n,) int64
    R: torch.Tensor      # (genes, p) float32


def preprocess(
    X: np.ndarray,
    cfg: SharpConfig,
    gene_names: Optional[np.ndarray] = None,
    cell_names: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Dedup genes/cells, clamp negatives, drop all-zero genes, normalize.

    Mirrors R/SHARP.R:82-117: duplicate gene/cell-name removal, `prep`
    (negative clamp + all-zero-gene drop), and CPM normalization when
    exp.type is given and is neither CPM nor TPM. X is cells x genes.
    While tracing, the spans `sharp.preprocess.{prep,normalize}` and the
    sums `preprocess.genes_dropped` and `preprocess.host_bytes` (the bytes
    the host's passes over the matrix read and write).
    """
    if cell_names is not None:
        _, idx = np.unique(np.asarray(cell_names), return_index=True)
        if len(idx) < X.shape[0]:
            X = X[np.sort(idx)]
    if gene_names is not None:
        _, idx = np.unique(np.asarray(gene_names), return_index=True)
        if len(idx) < X.shape[1]:
            X = X[:, np.sort(idx)]
    if cfg.prep:
        with span("preprocess.prep"):
            full = X.nbytes
            X = np.maximum(X, 0)
            nz = X.sum(axis=0) > 0
            dropped = int(nz.size - nz.sum())
            if dropped:
                X = X[:, nz]
            # the clamp reads and writes the matrix, the gene sums read it,
            # and a drop reads it and writes the genes kept
            add("preprocess.host_bytes", 3 * full + (full + X.nbytes if dropped else 0))
            add("preprocess.genes_dropped", dropped)
    if cfg.exp_type is not None and cfg.exp_type.upper() not in ("CPM", "TPM"):
        with span("preprocess.normalize"):
            per_cell = X.sum(axis=1, keepdims=True)
            X = X / np.maximum(per_cell, 1e-12) * 1e6
            # the cell sums read the matrix; the divide and the scale each
            # read and write it
            add("preprocess.host_bytes", 5 * X.nbytes)
    return np.ascontiguousarray(X, dtype=np.float32)


def draw_testlog_probe(
    rN_seed: int, n: int, genes: int, p: int, device
) -> TestlogProbe:
    """The probe's draws from the port's own streams (the reference pins
    seed 5 for the probe RP, R/SHARP.R:889)."""
    perm = torch.randperm(n, generator=testlog_generator(rN_seed, device), device=device)
    R = ternary_rp_matrix(fixed_generator(5, device), genes, p)
    return TestlogProbe(perm, R)


def testlog_decide(
    X: torch.Tensor,
    cfg: SharpConfig,
    rN_seed: int,
    sncells: Optional[int] = None,
    probe: Optional[TestlogProbe] = None,
    device=None,
) -> bool:
    """Decide whether to log2-transform by probing a small random subset.

    Reference rule (R/SHARP.R:877-924): cluster `sncells` random cells with
    one fixed-seed RP both raw and log2-transformed; log is necessary iff
    msil_raw < 0.75 and msil_raw >= 0.95 * msil_log. `probe` injects the
    permutation and probe RP matrix (e.g. the JAX package's, through
    `sharp_tpu_torch.carry`); by default they are drawn from `rN_seed`.
    The probe runs on `device` (default: X's device); only the probed
    cells move there.
    """
    n, genes = X.shape
    dev = X.device if device is None else torch.device(device)
    sn = min(sncells if sncells is not None else cfg.sncells, n)
    if probe is None:
        probe = draw_testlog_probe(rN_seed, n, genes, cfg.reduced_ndim, dev)
    npad = pad_dim(sn)
    Xp = torch.zeros((npad, genes), dtype=torch.float32, device=dev)
    Xp[:sn] = X[probe.perm[:sn].to(X.device)].to(dev)
    mask = torch.arange(npad, device=dev) < sn
    R = probe.R.to(dev)

    def maxsil_of(Z):
        res = opt_hclust(
            Z, mask, sn, 40, symmetric=False, minN=2, ncand=39,
            nc_pad=cfg.nc_pad, sil_thre=0.0, height_Ntimes=2.0,
        )
        return host_read(res.maxsil, "pipeline.testlog_maxsil")

    raw = maxsil_of(rp_project(Xp, R))
    logged = maxsil_of(rp_project(Xp, R, log_transform=True))
    flag = (raw < 0.75) and (raw >= 0.95 * logged)
    log(f"testlog: msil_raw={raw:.4f} msil_log={logged:.4f} -> log={flag}")
    return flag


def resolve_log_transform(
    X: torch.Tensor, cfg: SharpConfig, rN_seed: int,
    probe: Optional[TestlogProbe] = None, device=None,
) -> bool:
    """Reference decision tree for the final log2 flag (R/SHARP.R:202-228)."""
    if cfg.log_transform is not None:
        return bool(cfg.log_transform)
    if cfg.logflag is False:
        return True  # "Log-transform is employed!" without checking
    if cfg.logflag is None and cfg.n_cells >= 1e4:
        return True
    return testlog_decide(X, cfg, rN_seed, probe=probe, device=device)


def sharp_small(
    X: np.ndarray,
    cfg: SharpConfig,
    rN_seed: int,
    device,
    timer: Optional[StageTimer] = None,
    R_all: Optional[torch.Tensor] = None,
    testlog_probe: Optional[TestlogProbe] = None,
) -> SharpResult:
    """Small-data path ~ SHARP_small (R/SHARP.R:339-454) on `device`.

    `R_all` injects the stacked RP matrices (the reference's `rM`,
    R/SHARP.R:541-549) and `testlog_probe` the testlog draws; by default
    both are drawn from `rN_seed` on `device`.
    """
    timer = timer or StageTimer("small")
    n, genes = X.shape
    K = cfg.ensize_K
    p = cfg.reduced_ndim
    npad = pad_dim(n)
    dev = torch.device(device)

    with timer.stage("stage_rp_setup"):
        Xp = torch.zeros((npad, genes), dtype=torch.float32, device=dev)
        Xp[:n] = torch.from_numpy(X).to(dev)
        mask = torch.arange(npad, device=dev) < n
        if R_all is None:
            R_all = ensemble_rp_matrix(
                rN_seed, K, genes, p, dtype=getattr(torch, cfg.dtype_compute), device=dev
            )
        else:
            R_all = R_all.to(dev, getattr(torch, cfg.dtype_compute))

    with timer.stage("log_decision"):
        logf = resolve_log_transform(Xp[:n], cfg, rN_seed, probe=testlog_probe)

    with timer.stage("ensemble_cluster"):
        block = cluster_block_ensemble(
            Xp, mask, n, R_all, cfg.maxN_cluster, logf,
            K=K, minN=cfg.minN_cluster,
            ncand=cfg.maxN_cluster - cfg.minN_cluster + 1,
            nc_pad=cfg.nc_pad, sil_thre=cfg.sil_thre,
            height_Ntimes=cfg.height_Ntimes,
            indN_cluster=cfg.indN_cluster,
            linkage_backend=cfg.linkage_backend,
            hmethod=cfg.hmethod,
        )
        k_per = host_read(block.k_per, "pipeline.k_per").numpy()

    with timer.stage("wmetac"):
        wres = wmetac(
            block.labels, mask, n, cfg.maxN_cluster,
            K=K, nc_pad=cfg.nc_pad, allc_pad=_allc_pad(cfg),
            meta_minN=cfg.minN_cluster,
            meta_ncand=cfg.maxN_cluster - cfg.minN_cluster + 1,
            sil_thre=0.0,  # wMetaC defaults sil.thre to 0 (R/wMetaC.R:94-97)
            height_Ntimes=cfg.height_Ntimes,
            enN_cluster=cfg.N_cluster,
        )
        raw = host_read(wres.finalC, "pipeline.finalC").numpy()[:n]

    with timer.stage("finalize"):
        merge_tiny = cfg.N_cluster is None and n > 1e4
        labels = finalize_labels(raw, merge_tiny=merge_tiny)
        vals, counts = np.unique(labels, return_counts=True)
        viE = host_read(block.mean_proj[:n], "pipeline.viE").numpy() if cfg.forview else None
        x0 = host_read(wres.x0[:n], "pipeline.x0").numpy() if cfg.forview else None

    return SharpResult(
        pred_clusters=labels,
        N_pred_cluster=len(vals),
        unique_pred_clusters=[int(v) for v in vals],
        distr_pred_clusters={int(v): int(c) for v, c in zip(vals, counts)},
        viE=viE,
        x0=x0,
        paras=cfg.as_dict(),
        timing=timer.as_dict(),
        per_member_k=k_per,
        per_member_maxsil=host_read(block.maxsil, "pipeline.maxsil").numpy(),
    )
