"""Marker-gene identification: batched rank statistics on the device.

Counterpart of `sharp_tpu/analysis/markers.py`, the reference's per-gene
loop (R/get_marker_genes.R:25-261): per gene, the nonzero fraction; ranks
across cells; the candidate cluster(s) by top mean rank; AUROC; the
Wilcoxon rank-sum z; the fold change against the best other cluster. Holm,
the normal tail, the adaptive AUC threshold (:212-219), the rescue and the
sort (:223-236) stay on the host in numpy, as in the JAX package.

Genes go through in chunks. The statistics of a chunk are plain PyTorch on
the chunk's device: ranks from one sort and two searchsorted per gene (each
gene a row of the transposed (G, n) chunk), AUROC in its closed rank form
U / (n1 n2), the tie-corrected normal approximation with continuity
correction (R wilcox.test's large-sample path). The chunks' results stay on
the device and are read back once per call.

Exactness. `best` rests on exact comparisons (`mean_ranks == max`, the
argmax over AUROC), so the rank sums must not depend on the order of a sum.
Doubled average ranks (lo + hi + 1) and tie terms (g^2 - 1) are integers:
the rank sums are a float64 one-hot product of the doubled ranks, exact in
any order below 2^53 (they reach 2 n^2), and the tie sums are int64. Both
equal the JAX package's float32 sums wherever those are exact (n (n + 1) /
2 < 2^24, n up to 5,792). The rest of the chunk's arithmetic is the JAX
package's float32 operations in its order, one rounded operation each, so
dp, best and auc are the same bits on the card, on the CPU and in the JAX
package. z differs in the last bit (the JAX package's compiled code
multiplies by an approximate reciprocal square root where this divides by
the square root; the card and the CPU differed by 1.5e-7 relative on a
4,096-cell cut of the flagship block). The per-cluster mean expression (a float32 product, for
the fold change) rounds in the order of the device's matrix product. No
float atomics: the same call twice gives the same output.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from sharp_tpu_torch.types import SharpResult


@dataclasses.dataclass
class MarkerResult:
    mginfo: dict          # filtered marker table: arrays keyed by column
    gallinfo: dict        # per-gene stats for every tested gene
    mat: np.ndarray       # marker-gene expression rows (markers x cells)
    label: np.ndarray     # cluster labels used
    adauc: float          # adaptive AUC threshold actually applied

    @property
    def n_markers(self) -> int:
        return len(self.mginfo["gene"])


def _tie_bounds(Xt: torch.Tensor):
    """lo, hi (G, n) int64 for each gene, a row of Xt (G, n): the number of
    the gene's values below and at most each value (searchsorted left and
    right in the sorted row). The average rank with ties (R's rank()) is
    (lo + hi + 1) / 2."""
    xs = torch.sort(Xt, dim=1).values
    lo = torch.searchsorted(xs, Xt, right=False)
    hi = torch.searchsorted(xs, Xt, right=True)
    return lo, hi


def _gene_chunk_stats(
    Xg: torch.Tensor, oh: torch.Tensor, counts: torch.Tensor, *, C: int, ng: int = 1
):
    """Per-gene stats for a (n, G) float32 chunk against (n, C) one-hot
    labels and (C,) float32 counts, all on one device.

    `ng` = number of candidate clusters considered per gene: the top-ng by
    mean rank, keeping the one with the best AUROC (R/get_marker_genes.R:
    135-144; the gene-partitioned variant uses ng = min(10, C),
    R/get_marker_genes_unlimited2.R:184,229).

    Returns dp, best cluster (int32), auc, z (signed Wilcoxon z), fc, all
    (G,) on the chunk's device.
    """
    n = Xg.shape[0]
    f32 = np.float32
    nf = torch.tensor(float(n), dtype=torch.float32, device=Xg.device)
    # the JAX package's compiled code divides by a constant (n, 12, n (n -
    # 1)) as a product with its float32 reciprocal (XLA rewrites it so);
    # these products keep its bits
    inv_n = float(f32(1.0) / f32(n))
    inv_nn1 = float(f32(1.0) / (f32(n) * (f32(n) - f32(1.0))))
    inv_12 = float(f32(1.0) / f32(12.0))
    dp = (Xg > 0).sum(dim=0).to(torch.float32) * inv_n

    lo, hi = _tie_bounds(Xg.T.contiguous())                       # (G, n)
    # exact: doubled ranks are integers, their float64 sums stay below 2^53
    rank2 = (lo + hi + 1).to(torch.float64)
    rank_sums = (0.5 * (rank2 @ oh.to(torch.float64))).T.to(torch.float32)  # (C, G)
    g = hi - lo
    ts = (g * g - 1).sum(dim=1).to(torch.float32)                 # (G,)
    del lo, hi, rank2, g
    mean_ranks = rank_sums / torch.clamp_min(counts[:, None], 1.0)

    # AUROC closed form for every cluster, then the top-ng mean-rank
    # candidates; ties of the argmax go to the first index
    U_all = rank_sums - (counts * (counts + 1.0) / 2.0)[:, None]
    auc_all = U_all / torch.clamp_min((counts * (nf - counts))[:, None], 1.0)
    if ng >= C:
        cand = torch.ones_like(auc_all, dtype=torch.bool)
    elif ng == 1:
        cand = mean_ranks == mean_ranks.max(dim=0, keepdim=True).values
    else:
        kth = torch.sort(mean_ranks, dim=0).values[C - ng]        # (G,)
        cand = mean_ranks >= kth[None, :]
    best = torch.argmax(torch.where(cand, auc_all, -torch.inf), dim=0)   # (G,)

    n1 = counts[best]
    n2 = nf - n1
    rs1 = torch.gather(rank_sums, 0, best[None, :])[0]
    U = rs1 - n1 * (n1 + 1.0) / 2.0
    auc = U / torch.clamp_min(n1 * n2, 1.0)

    sigma2 = (n1 * n2 * inv_12) * ((nf + 1.0) - ts * inv_nn1)
    sigma = torch.sqrt(torch.clamp_min(sigma2, 1e-12))
    mu = n1 * n2 / 2.0
    diff = U - mu
    z = (diff - 0.5 * torch.sign(diff)) / sigma                  # continuity corr.

    mean_expr = oh.T @ Xg
    mean_expr = mean_expr / torch.clamp_min(counts[:, None], 1.0)     # (C, G)
    own_mean = torch.gather(mean_expr, 0, best[None, :])[0]
    others = torch.where(
        torch.arange(C, device=Xg.device)[:, None] == best[None, :], -torch.inf, mean_expr
    )
    best_other = others.max(dim=0).values
    fc = own_mean / torch.clamp_min(best_other, 1e-12)

    return dp, best.to(torch.int32), auc, z, fc


class _BlockedColumns:
    """Column-sliceable view over a list of row-blocks (cells split across
    blocks, genes shared): lets the chunked statistics stream blocked data."""

    def __init__(self, blocks):
        self.blocks = [np.asarray(b) for b in blocks]
        g = {b.shape[1] for b in self.blocks}
        if len(g) != 1:
            raise ValueError("all blocks must share the gene dimension")
        self.shape = (sum(b.shape[0] for b in self.blocks), g.pop())

    def __getitem__(self, key):
        rows, cols = key
        return np.concatenate([b[rows, cols] for b in self.blocks], axis=0)


def _holm(p: np.ndarray) -> np.ndarray:
    """Holm step-down adjustment (R p.adjust(method='holm'))."""
    m = len(p)
    order = np.argsort(p)
    adj = np.empty(m)
    running = 0.0
    for rank, idx in enumerate(order):
        running = max(running, (m - rank) * p[idx])
        adj[idx] = min(running, 1.0)
    return adj


def _label_encoding(y, dev):
    """(labels, uniq, C, one-hot (n, C) float32 and counts (C,) float32 on dev)."""
    labels = np.asarray(y.pred_clusters if isinstance(y, SharpResult) else y)
    uniq = np.unique(labels)
    C = len(uniq)
    enc = np.searchsorted(uniq, labels)
    oh = torch.from_numpy(np.eye(C, dtype=np.float32)[enc]).to(dev)
    counts = torch.from_numpy(np.bincount(enc, minlength=C).astype(np.float32)).to(dev)
    return labels, uniq, C, oh, counts


def _chunk_to_device(X, start: int, chunk: int, dev) -> torch.Tensor:
    """Columns [start, start + chunk) of the host matrix X as a float32
    tensor on dev (a strided gather of each row's slice on the host)."""
    return torch.from_numpy(np.ascontiguousarray(X[:, start : start + chunk], np.float32)).to(dev)


def _read_back(parts):
    """The chunks' (dp, best, auc, z, fc) tuples, concatenated on the device
    and read back once."""
    return [torch.cat(col).cpu().numpy() for col in zip(*parts)]


def get_marker_genes(
    X,
    y: Union[SharpResult, np.ndarray, Sequence[int]],
    *,
    gene_names: Optional[Sequence[str]] = None,
    theta: float = 1e-4,
    auc_thre: float = 0.7,
    p_thre: float = 0.01,
    fc_thre: float = 2.0,
    chunk: int = 2048,
    device="cuda",
) -> MarkerResult:
    """Identify per-cluster marker genes (~ get_marker_genes,
    R/get_marker_genes.R:25) on `device`. X is cells x genes: one matrix,
    or a list of row-blocks (the blocked variants get_marker_genes_unlimited*,
    R/get_marker_genes_unlimited.R:25, are just more chunks here). `y` a
    SharpResult or a label vector. Defaults match the reference (:36-54)."""
    from sharp_tpu_torch.api import resolve_device

    dev = resolve_device(device)
    if isinstance(X, (list, tuple)):
        X = _BlockedColumns(X)
    n, D = X.shape
    labels, uniq, C, oh, counts = _label_encoding(y, dev)
    parts = [
        _gene_chunk_stats(_chunk_to_device(X, start, chunk, dev), oh, counts, C=C)
        for start in range(0, D, chunk)
    ]
    dp, best, auc, z, fc = _read_back(parts)

    gallinfo, mginfo, idx, adauc = _finish(
        dp, best, auc, z, fc, uniq, C,
        theta=theta, auc_thre=auc_thre, p_thre=p_thre, fc_thre=fc_thre,
        gene_names=gene_names,
    )
    mat = np.ascontiguousarray(X[:, idx].T, np.float32)
    return MarkerResult(mginfo=mginfo, gallinfo=gallinfo, mat=mat, label=labels, adauc=adauc)


def _finish(
    dp, best, auc, z, fc, uniq, C, *, theta, auc_thre, p_thre, fc_thre,
    gene_names,
):
    """Shared marker postprocessing on the host: Holm adjustment, adaptive
    AUC threshold, filtering + per-cluster rescue, reference sort order.
    Returns (gallinfo, mginfo, selected gene indices, adauc)."""
    from scipy.stats import norm

    D = len(dp)
    pvals = 2.0 * norm.sf(np.abs(z))
    tested = dp > theta
    p_adj = np.ones(D)
    p_adj[tested] = _holm(pvals[tested])

    names = (
        np.asarray(gene_names)
        if gene_names is not None
        else np.array([f"g{i}" for i in range(D)])
    )
    gallinfo = {
        "gene": names,
        "gene_index": np.arange(D),
        "cluster": uniq[best],
        "sparsity": dp,
        "auc": auc,
        "pvalue": pvals,
        "p_adj": p_adj,
        "fold_change": fc,
        "tested": tested,
    }

    # adaptive AUC threshold: never let a cluster lose all its markers
    # (R/get_marker_genes.R:212-219)
    adauc = auc_thre
    for c in range(C):
        in_c = tested & (best == c)
        if in_c.any():
            adauc = min(adauc, auc[in_c].max())
    adauc = float(adauc)

    keep = tested & (p_adj < p_thre) & (auc >= adauc) & (fc >= fc_thre)
    # per-cluster rescue: clusters emptied by p/fc filters keep their best-AUC gene
    for c in range(C):
        if not (keep & (best == c)).any():
            in_c = tested & (best == c)
            if in_c.any():
                gidx = np.flatnonzero(in_c)[np.argmax(auc[in_c])]
                keep[gidx] = True

    idx = np.flatnonzero(keep)
    order = np.lexsort(
        (dp[idx] * -1, pvals[idx], -auc[idx], -fc[idx], uniq[best[idx]])
    )
    idx = idx[order]
    mginfo = {k: v[idx] for k, v in gallinfo.items() if k != "tested"}
    return gallinfo, mginfo, idx, adauc


def get_marker_genes_unlimited2(
    gene_blocks,
    y: Union[SharpResult, np.ndarray, Sequence[int]],
    *,
    gene_names: Optional[Sequence[str]] = None,
    theta: float = 1e-5,
    auc_thre: float = 0.85,
    p_thre: float = 0.05,
    fc_thre: float = 2.0,
    ng: Optional[int] = None,
    chunk: int = 2048,
    device="cuda",
) -> MarkerResult:
    """Marker genes from GENE-PARTITIONED input (~ get_marker_genes_unlimited2,
    R/get_marker_genes_unlimited2.R:25) on `device`.

    `gene_blocks` is a directory of stored files, or a list of arrays /
    file paths, each holding ALL cells x a slice of the genes (the
    transpose of the cell-blocked layout). Files are visited one at a time
    in numeric filename order (R :159-162); only per-gene scalar stats are
    kept, so the full genes axis never has to fit at once.

    Defaults follow the reference variant (R :36-46): theta=1e-5, AUC=0.85,
    p=0.05, and candidate clusters = the top min(10, C) mean ranks (R
    :184,229), keeping the candidate with the best AUROC.
    """
    from sharp_tpu_torch.api import resolve_device
    from sharp_tpu_torch.io.blocks import BlockStore

    dev = resolve_device(device)
    labels, uniq, C, oh, counts = _label_encoding(y, dev)
    ng_eff = min(10, C) if ng is None else min(ng, C)

    # resolve input form -> a loader per gene-block
    if isinstance(gene_blocks, str):
        files = BlockStore(gene_blocks).files()
        loaders = [lambda f=f: BlockStore.load(f) for f in files]
    else:
        loaders = []
        for b in gene_blocks:
            if isinstance(b, str):
                loaders.append(lambda f=b: BlockStore.load(f))
            else:
                loaders.append(lambda a=b: np.asarray(a, np.float32))

    parts = []
    block_cols = []
    for load in loaders:
        Xb = load()
        if Xb.shape[0] != len(labels):
            raise ValueError(
                f"gene block has {Xb.shape[0]} cells, labels have "
                f"{len(labels)} — gene-partitioned blocks must share the "
                "cell axis"
            )
        block_cols.append(Xb.shape[1])
        for start in range(0, Xb.shape[1], chunk):
            parts.append(
                _gene_chunk_stats(_chunk_to_device(Xb, start, chunk, dev), oh, counts, C=C, ng=ng_eff)
            )
        del Xb
    dp, best, auc, z, fc = _read_back(parts)

    gallinfo, mginfo, idx, adauc = _finish(
        dp, best, auc, z, fc, uniq, C,
        theta=theta, auc_thre=auc_thre, p_thre=p_thre, fc_thre=fc_thre,
        gene_names=gene_names,
    )

    # marker expression rows: revisit only the files holding selected genes
    offsets = np.concatenate([[0], np.cumsum(block_cols)])
    mat = np.zeros((len(idx), len(labels)), np.float32)
    pos_of = {int(g): i for i, g in enumerate(idx)}
    for bi, load in enumerate(loaders):
        lo, hi = offsets[bi], offsets[bi + 1]
        local = [g for g in idx if lo <= g < hi]
        if not local:
            continue
        Xb = load()
        for g in local:
            mat[pos_of[int(g)]] = Xb[:, int(g - lo)]
        del Xb

    return MarkerResult(mginfo=mginfo, gallinfo=gallinfo, mat=mat, label=labels, adauc=adauc)
