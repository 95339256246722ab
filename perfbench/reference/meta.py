"""Plain reference of the meta-clustering: wMetaC over a fold's K members,
the fold summary, sMetaC over fold clusters, the per-block and global fuses
and the final relabelling.

Written from SHARP's R/wMetaC.R, R/sMetaC.R, R/SHARP.R and
R/SHARP_unlimited.R with the conventions its Python ports document; imports
torch and numpy only. Meta problems are unpadded, except where a stated
padded width enters the result: the Calinski-Harabasz features of a
similarity problem are its rows padded with zeros to that width
(`sim_width`), as the ports compute them.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from perfbench.reference.cluster import mm, note_taken, opt_hclust, pearson_distance, project, unit_rows
from perfbench.reference.compare import label_gap


def _closest(options, prefer, rooms) -> int:
    """The index of the first option, or where the program's own answer
    `prefer` is given, of the option nearest it: among choices the
    reference's rounding cannot tell apart, the one the program took
    (noted with the room it needed, `rooms[i]`)."""
    if prefer is None or len(options) == 1:
        return 0
    i = min(range(len(options)), key=lambda i: label_gap(prefer, options[i]))
    note_taken(rooms[i])
    return i


class FoldRef(NamedTuple):
    """One fold's reference: consensus labels and the summary of its clusters."""

    finalC: np.ndarray      # (n,) consensus labels
    maxsil: np.ndarray      # (K,) max median silhouette of each member
    mean_proj: torch.Tensor  # (n, p) ensemble-mean projection


def _padded_features(S: torch.Tensor, width: int) -> torch.Tensor:
    n = S.shape[-1]
    F = torch.zeros((*S.shape[:-1], max(width, n)), device=S.device)
    F[..., :n] = S
    return F


def wmetac(labels: torch.Tensor, *, maxN: int, minN: int, ncand: int, nc_cap: int,
           sim_width: int, height_Ntimes: float, prefer=None) -> np.ndarray:
    """Consensus of K member labellings (n, K) of one fold -> finalC (n,);
    `prefer`: the program's consensus (see `_closest`)."""
    n, K = labels.shape
    dev = labels.device
    W = int(labels.max()) + 1
    oh = torch.nn.functional.one_hot(labels, W).float()                 # (n, K, W)
    flat = oh.reshape(n, K * W)
    A = mm(flat, flat.T) / K
    w0 = (4.0 / n) * (A * (1.0 - A)).sum(dim=1)
    w1 = (w0 + 0.01) / 1.01
    # member clusters in (member, cluster id) order
    occ = oh.sum(dim=0) > 0.5                                           # (K, W)
    mk, mc = torch.nonzero(occ, as_tuple=True)
    M = oh[:, mk, mc].T                                                 # (allC, n)
    allC = M.shape[0]
    Mw = M * w1[None, :]
    inter = mm(Mw, M.T)
    wsum = Mw.sum(dim=1)
    union = wsum[:, None] + wsum[None, :] - inter
    S = torch.where((inter > 0) & (union > 1e-12), inter / torch.clamp_min(union, 1e-12), 0.0)
    S.fill_diagonal_(1.0)
    res = opt_hclust((1.0 - S)[None] * (1.0 - torch.eye(allC, device=dev)), _padded_features(S, sim_width)[None],
                     minN=minN, ncand=ncand, maxN=min(maxN, allC - 1), nc_cap=nc_cap,
                     sil_thre=0.0, height_Ntimes=height_Ntimes)
    slot = torch.full((K, W), -1, dtype=torch.long, device=dev)
    slot[mk, mc] = torch.arange(allC, device=dev)
    options = []
    for o in res["alts"][0]:
        tf = res["cuts"][0, o]                                          # (allC,)
        member_meta = tf[slot[torch.arange(K, device=dev)[None, :], labels]]  # (n, K)
        votes = torch.nn.functional.one_hot(member_meta, int(tf.max()) + 1).float().sum(dim=1)
        finalC = torch.argmax(votes, dim=1)
        if len(torch.unique(finalC)) == 1:
            other = votes.scatter(1, finalC[:, None], -1.0)
            finalC = torch.where(other.amax(dim=1) > 0.5, torch.argmax(other, dim=1), finalC)
        options.append(finalC.cpu().numpy())
    return options[_closest(options, prefer, res["rooms"][0])]


def fold(X: torch.Tensor, R: torch.Tensor, cfg: dict, log: bool = True, prefer=None) -> FoldRef:
    """The reference of one fold of n cells X (n, genes): projection,
    members' Ward and cut choice, wMetaC. `cfg` holds K, rp_kind, minN,
    maxN, ncand, nc_cap, sil_thre, height_Ntimes, sim_width, and may hold
    mm_kind, the precision of the distances' product (float32). `prefer`:
    the program's answer (`k_per`, `finalC`), followed only where the
    reference's own choice is within rounding of it (`cluster.choose`)."""
    K = cfg["K"]
    proj = project(X, R, K, log, cfg["rp_kind"])                        # (K, n, p)
    D = pearson_distance(proj, cfg.get("mm_kind", "float32"))
    prefer = prefer or {}
    res = opt_hclust(D, proj, minN=cfg["minN"], ncand=cfg["ncand"], maxN=cfg["maxN"],
                     nc_cap=cfg["nc_cap"], sil_thre=cfg["sil_thre"], height_Ntimes=cfg["height_Ntimes"],
                     prefer_k=prefer.get("k_per"))
    finalC = wmetac(res["labels"].T, maxN=cfg["maxN"], minN=cfg["minN"], ncand=cfg["ncand"],
                    nc_cap=cfg["nc_cap"], sim_width=cfg["sim_width"], height_Ntimes=cfg["height_Ntimes"],
                    prefer=prefer.get("finalC"))
    return FoldRef(finalC=finalC, maxsil=res["maxsil"], mean_proj=proj.mean(dim=0))


def smetac_range(n_cells: int, minN: int, maxN: int, n_clusters: int):
    """The search range of sMetaC, which depends on the data set's size
    (R/sMetaC.R:103-119)."""
    if n_cells < 1e6:
        baseN = min(max(n_cells // 10000, 2), 10)
        if minN == 2 and min(maxN, n_clusters) - baseN >= 3:
            minN = baseN
    else:
        maxN = max(maxN, n_cells // 5000)
        minN = max(minN, n_cells // 50000)
    return int(minN), int(maxN)


def nc_pad(maxN_cluster: int) -> int:
    """The stated padded width of a fold's cluster ids: min(maxN, 40) + 2,
    rounded up to 8; the last slot is never a cluster."""
    return -(-(min(maxN_cluster, 40) + 2) // 8) * 8


def allc_pad(K: int, maxN_cluster: int) -> int:
    """The stated padded width of wMetaC's member-cluster problem."""
    exact = K * min(maxN_cluster + 1, nc_pad(maxN_cluster) - 1)
    return min(max(64, -(-exact // 64) * 64), 1024)


def pad_dim(n: int) -> int:
    """The padded size of a problem of n points: powers of two up to 512,
    then multiples of 512."""
    n = max(n, 8)
    return 1 << (n - 1).bit_length() if n <= 512 else -(-n // 512) * 512


def smetac(cents: np.ndarray, *, minN: int, ncand: int, maxN: int, meta_cap: int, width: int,
           sil_thre: float, height_Ntimes: float, dev) -> list:
    """sMetaC of NC cluster centroids (NC, p) -> the meta label of each
    (0..k-1 by first member), with the reference's second-best override:
    the reference's choice first, then each choice within rounding of it;
    and the room each needed (`cluster.choose`)."""
    NC = cents.shape[0]
    C = torch.as_tensor(cents, dtype=torch.float32, device=dev)
    U = unit_rows(C)
    S = mm(U, U.T)
    S.fill_diagonal_(1.0)
    res = opt_hclust((1.0 - S)[None] * (1.0 - torch.eye(NC, device=dev)), _padded_features(S, width)[None],
                     minN=minN, ncand=ncand, maxN=maxN, nc_cap=meta_cap,
                     sil_thre=sil_thre, height_Ntimes=height_Ntimes)
    msil = res["msil"][0]
    valid = np.isfinite(msil)
    out = []
    for o in res["alts"][0]:
        if int(res["cuts"][0, o].max()) == 1 and res["maxsil"][0] > sil_thre and ncand > 1 and valid.sum() >= 2:
            o = int(np.argmax(valid & (msil == np.sort(msil[valid])[-2])))
        out.append(res["cuts"][0, o].cpu().numpy())
    return out, res["rooms"][0]


class BlockFuse(NamedTuple):
    labels: np.ndarray   # (cells,) the block's meta label of each cell, fold order
    cents: np.ndarray    # (C, p) centroid of each live meta cluster
    counts: np.ndarray   # (C,) cells of each


def fuse_block(folds: List[dict], cfg: dict, dev, prefer=None) -> BlockFuse:
    """The per-block sMetaC over its folds' summaries (dicts with finalC,
    cent_sum, counts); `cfg` holds n_cells, minN, maxN_cluster, nc_pad,
    sil_thre, height_Ntimes. Labels are numbered 0..C-1 in meta order.
    `prefer`: the program's block labels (see `_closest`)."""
    nc = cfg["nc_pad"]
    if len(folds) == 1:
        fr = folds[0]
        uniq = np.unique(fr["finalC"])
        cs = fr["cent_sum"][uniq] / np.maximum(fr["counts"][uniq], 1.0)[:, None]
        return BlockFuse(np.searchsorted(uniq, fr["finalC"]), cs.astype(np.float32), fr["counts"][uniq])
    counts = np.stack([fr["counts"][: nc - 1] for fr in folds])
    t_idx, c_idx = np.nonzero(counts > 0)
    sums = np.stack([fr["cent_sum"] for fr in folds])[t_idx, c_idx].astype(np.float32)
    cnt = counts[t_idx, c_idx].astype(np.float32)
    NC = len(t_idx)
    NC_pad = pad_dim(NC)
    minN, eff_maxN = smetac_range(cfg["n_cells"], cfg["minN"], cfg["maxN_cluster"], NC)
    maxN = min(eff_maxN, NC - 1) if NC > 1 else 1
    if maxN < minN:
        minN = max(2, maxN)
    budget = min(eff_maxN, NC_pad)
    tfs, rooms = smetac(sums / np.maximum(cnt, 1.0)[:, None], minN=minN, ncand=max(budget - minN + 1, 1),
                 maxN=maxN, meta_cap=((budget + 9) // 8) * 8 - 1, width=NC_pad,
                 sil_thre=cfg["sil_thre"], height_Ntimes=cfg["height_Ntimes"], dev=dev)
    options = []
    for tf in tfs:
        local = np.full((len(folds), nc), -1, np.int64)      # -1: no cluster of the fold
        local[t_idx, c_idx] = tf
        options.append(np.concatenate([local[t][fr["finalC"]] for t, fr in enumerate(folds)]))
    i = _closest(options, prefer, rooms)
    labels, tf = options[i], tfs[i]
    k = int(tf.max()) + 1
    msum = np.zeros((k, sums.shape[1]), np.float32)
    mcnt = np.zeros(k, np.float32)
    np.add.at(msum, tf, sums)
    np.add.at(mcnt, tf, cnt)
    uniq = np.unique(labels)
    return BlockFuse(np.searchsorted(uniq, labels), (msum / np.maximum(mcnt, 1.0)[:, None])[uniq], mcnt[uniq])


def global_fuse(blocks: List[BlockFuse], cfg: dict, dev, prefer=None) -> np.ndarray:
    """The global sMetaC over the blocks' clusters, the relabel by
    decreasing size, and the final labels (1-based) of every cell;
    `prefer`: the program's final labels (see `_closest`)."""
    merge = cfg["n_cells"] > 1e4
    if len(blocks) == 1:
        return finalize(blocks[0].labels, merge_tiny=merge)
    cents = np.concatenate([b.cents for b in blocks])
    counts = np.concatenate([b.counts for b in blocks])
    NC = len(counts)
    minN, maxN = smetac_range(cfg["n_cells"], cfg["minN"], cfg["maxN_cluster"], NC)
    maxN = min(maxN, NC - 1) if NC > 1 else 1
    if maxN < minN:
        minN = max(2, maxN)
    tfs, rooms = smetac(cents, minN=minN, ncand=max(maxN - minN + 1, 1), maxN=maxN,
                 meta_cap=((min(maxN, NC) + 9) // 8) * 8 - 1, width=pad_dim(NC),
                 sil_thre=cfg["sil_thre"], height_Ntimes=cfg["height_Ntimes"], dev=dev)
    offsets = np.concatenate([[0], np.cumsum([len(b.counts) for b in blocks])])
    options = []
    for tf in tfs:
        sizes = np.zeros(int(tf.max()) + 1)
        np.add.at(sizes, tf, counts)
        order = np.argsort(-sizes, kind="stable")
        remap = np.empty(len(sizes), np.int64)
        remap[order] = np.arange(1, len(sizes) + 1)
        raw = np.concatenate([remap[tf[offsets[i] + b.labels]] for i, b in enumerate(blocks)])
        options.append(finalize(raw, merge_tiny=merge))
    return options[_closest(options, prefer, rooms)]


def finalize(y: np.ndarray, merge_tiny: bool, tiny: int = 10) -> np.ndarray:
    """Clusters of fewer than `tiny` cells merged into one (when asked),
    then labels 1..C by first occurrence (R/SHARP.R:418-443)."""
    y = np.asarray(y).copy()
    if merge_tiny:
        vals, cnt = np.unique(y, return_counts=True)
        small = vals[cnt < tiny]
        if len(small):
            y[np.isin(y, small)] = small.min()
    _, first = np.unique(y, return_index=True)
    order = y[np.sort(first)]
    lut = {v: i + 1 for i, v in enumerate(order)}
    return np.asarray([lut[v] for v in y], np.int64)
