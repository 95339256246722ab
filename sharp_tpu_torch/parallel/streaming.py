"""Out-of-core / blocked clustering: the SHARP_unlimited family.

Counterpart of `sharp_tpu/parallel/streaming.py`, mirroring
R/SHARP_unlimited.R:29-242 and the streaming variant
R/SHARP_unlimited3.R:59-131: the RP matrices are shared by all blocks, one
block is resident at a time, each block runs the fold pass and its own
sMetaC fuse, one global sMetaC runs over the block-cluster centroids, and
the final clusters are relabelled by decreasing size
(R/SHARP_unlimited.R:179-183).

Beyond the reference: the next block loads on a worker thread while the
device clusters the current one; SBLK and scipy blocks go to the device as
CSR triplets and are densified there (`io/sparse.py`), staged by one
sparse feed for the whole call (`parallel/sharded.SparsePipeline`), which
slices and copies the next block's first fold group while the current
block's last group runs; and each finished block persists its summary
(labels and cluster centroids) in a manifest, so a killed run resumes at
the last finished block. With `n_devices > 1` a block's folds run over a
mesh of devices (`parallel/sharded.py`); with `multihost=True` several
processes take disjoint slices of the blocks and meet once, at the
all-gather of the block summaries (`parallel/multihost.py`).
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from sharp_tpu_torch.config import SharpConfig, pad_dim, resolve_config
from sharp_tpu_torch.core.large import fold_sizes, fuse_blocks
from sharp_tpu_torch.core.smetac import smetac, smetac_range
from sharp_tpu_torch.io.blocks import BlockStore
from sharp_tpu_torch.ops.rp import ensemble_rp_matrix
from sharp_tpu_torch.types import SharpResult
from sharp_tpu_torch.utils.prng import resolve_seed, view_generator
from sharp_tpu_torch.utils.timers import StageTimer, host_read, log, span, sub

def _config_fingerprint(cfg: SharpConfig, wire_dtype: str = "float32") -> str:
    """The manifest key of a run's configuration. forview is part of it (a
    forview=False manifest lacks the x0/viE planes a forview=True resume
    needs), and so is the wire dtype (the bfloat16 wire rounds the values,
    so its block summaries are not the float32 wire's)."""
    keys = (
        "reduced_ndim", "ensize_K", "partition_ncells", "minN_cluster",
        "maxN_cluster", "sil_thre", "height_Ntimes", "rN_seed", "nc_pad",
        "forview",
    )
    fields = {k: getattr(cfg, k) for k in keys}
    fields["wire_dtype"] = wire_dtype
    payload = json.dumps(fields, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _fold_layout(Xb, cfg: SharpConfig):
    """(fold sizes, block_pad) of a block."""
    sizes = fold_sizes(Xb.shape[0], cfg.partition_ncells)
    return sizes, pad_dim(max(sizes))


def _fold_pass(Xb, cfg: SharpConfig, R_all, logf: bool, device, mesh=None,
               group: Optional[int] = None, wire_dtype: str = "float32", feed: Optional[dict] = None,
               pipeline=None):
    """One block's fold pass -> list of per-fold summaries. Xb is a dense
    (cells, genes) array or a SparseBlock. With a mesh, a block of two or
    more folds fans its folds out over the mesh (the JAX package's
    `_fold_pass`, :72-87; `parallel/sharded.process_folds`). `feed` adds
    up the feed's host seconds, `pipeline` stages a SparseBlock's groups
    (`process_folds`)."""
    from sharp_tpu_torch.io.sparse import SparseBlock
    from sharp_tpu_torch.parallel.sharded import process_folds

    sizes, block_pad = _fold_layout(Xb, cfg)
    X = Xb if isinstance(Xb, SparseBlock) else np.asarray(Xb, np.float32)
    return process_folds(X, sizes, block_pad, R_all, cfg, logf, device, mesh, group=group,
                         wire_dtype=wire_dtype, feed=feed, pipeline=pipeline)


# what each fold's summary leaves in the result's diagnostics
_FOLD_DIAGNOSTICS = ("finalC", "cent_sum", "counts", "k_per", "maxsil")


def _fold_diagnostics(blocks_folds) -> dict:
    """The result's per-fold diagnostics over the blocks' folds, in block
    order (`sharp_unlimited`), or none where a block has no folds here
    (resumed from its manifest)."""
    if not blocks_folds or any(b is None for b in blocks_folds):
        return {}
    frs = [fr for b in blocks_folds for fr in b]
    sizes = [len(fr["finalC"]) for fr in frs]
    return dict(
        folds=np.repeat(np.arange(len(frs), dtype=np.int32), sizes),
        per_member_k=np.stack([fr["k_per"] for fr in frs]),
        per_member_maxsil=np.stack([fr["maxsil"] for fr in frs]),
        fold_labels=np.concatenate([fr["finalC"] for fr in frs]).astype(np.int32),
        fold_cent_sum=np.stack([fr["cent_sum"] for fr in frs]),
        fold_counts=np.stack([fr["counts"] for fr in frs]),
    )


def _block_summary(fres):
    """(labels (nb,), centroids (C, p), sizes (C,), x0c) of a block fuse.

    Block-cluster centroids are the fuse's per-meta centroids in the shared
    mean-RP feature space. `x0c` is the per-cell wMetaC vote matrix with its
    columns compacted to the block's live clusters, or None when the fold
    pass ran without forview.
    """
    uniq = np.unique(fres.labels)
    cents = fres.cents[uniq]
    counts = fres.counts[uniq]
    pos = np.searchsorted(uniq, fres.labels)  # labels as positions in uniq
    x0c = None
    if fres.x0 is not None:
        x0c = np.ascontiguousarray(fres.x0[:, uniq], dtype=np.float32)
    return pos.astype(np.int32), cents.astype(np.float32), counts, x0c


def _view_rp_matrix(cfg: SharpConfig, rN_seed: int, device="cpu") -> Optional[np.ndarray]:
    """The shared view projection (R/SHARP_unlimited.R:216-235): above 1e5
    cells the p-dim viE is projected to 50 view dimensions by one ternary
    RP matrix shared by all blocks, drawn from the run's seed
    (`view_generator`) on `device`; below, viE stays in the p-dim RP space
    and there is none."""
    if cfg.n_cells <= 1e5 or cfg.reduced_ndim <= 50:
        return None
    from sharp_tpu_torch.ops.rp import ternary_rp_matrix

    R = ternary_rp_matrix(view_generator(rN_seed, device), cfg.reduced_ndim, 50)
    return host_read(R, "streaming.view_rp").numpy().astype(np.float32) / np.sqrt(50.0)


def _block_view_features(frs: List[dict], R_view) -> np.ndarray:
    """Per-cell viE of one block (fold order), view-projected if R_view."""
    viE = np.concatenate([np.asarray(fr["mean_proj"], np.float32) for fr in frs], axis=0)
    return viE @ R_view if R_view is not None else viE


def _gather_summaries(block_results, cfg: SharpConfig, n_blocks: int, pcount: int):
    """Every process's block summaries, in global block order: each
    process's (centroids, counts) padded to a budget that covers the most
    clusters a block can have (maxN after the smetac_range widening at >=
    1e6 cells, R/sMetaC.R:103-119), one all-gather, and the padding cut off
    (a cluster has at least one cell)."""
    from sharp_tpu_torch.parallel.multihost import allgather_summaries, block_slice, pad_block_summary

    p = cfg.reduced_ndim
    _, eff_maxN = smetac_range(cfg.n_cells, cfg.minN_cluster, cfg.maxN_cluster, 1 << 30)
    bud = ((eff_maxN + 9) // 8) * 8
    max_local = (n_blocks + pcount - 1) // pcount
    payload = np.zeros((max_local, bud, p + 1), np.float32)
    for bi, (_, cents, counts, _x0, _v) in enumerate(block_results):
        cp, cc = pad_block_summary(cents, counts, bud)
        payload[bi, :, :p] = cp
        payload[bi, :, p] = cc
    gathered = allgather_summaries(payload, pcount).reshape(pcount, max_local, bud, p + 1)
    summaries = []
    for h in range(pcount):
        for bi in range(len(block_slice(n_blocks, h, pcount))):
            blk = gathered[h, bi]
            C = int((blk[:, p] > 0).sum())
            summaries.append((blk[:C, :p], blk[:C, p]))
    return summaries


def global_block_fuse(summaries, cfg: SharpConfig, device="cuda"):
    """Global sMetaC over block summaries + size-ordered relabelling
    (R/SHARP_unlimited.R:162-183), on `device` (a CUDA request without a
    card raises, `api.resolve_device`).

    summaries: (centroids (C_b, p) float32, counts (C_b,)) per block, in
    block order. Returns (tf, remap, offsets, order, meta_sizes): the meta
    label of each global block-cluster id, the 1-based size-ordered final
    id of each meta label, each block's first global cluster id, the meta
    labels by decreasing size and the cells of each meta label.
    """
    from sharp_tpu_torch.api import resolve_device

    device = resolve_device(device)
    with span("global_block_fuse"):
        return _global_block_fuse(summaries, cfg, device)


def _global_block_fuse(summaries, cfg: SharpConfig, device: torch.device):
    if len(summaries) == 1:
        # one block's consensus IS the final clustering: re-clustering its
        # ~k near-equidistant centroids has no replica structure for sMetaC
        # (the reference degrades a single block to SHARP,
        # R/SHARP_unlimited.R:39-51)
        counts = summaries[0][1]
        C = len(counts)
        tf = np.arange(C, dtype=np.int32)
        offsets = np.asarray([0, C])
        meta_sizes = counts.astype(np.float64)
        present = np.nonzero(meta_sizes > 0)[0]
        order = present[np.argsort(-meta_sizes[present], kind="stable")]
        remap = np.zeros(max(C, 1), np.int32)
        remap[order] = np.arange(1, len(order) + 1)
        return tf, remap, offsets, order, meta_sizes

    all_cents = np.concatenate([c for c, _ in summaries], axis=0)
    all_counts = np.concatenate([n for _, n in summaries])
    NC = all_cents.shape[0]
    NC_pad = pad_dim(max(NC, 8))
    cents_p = np.zeros((NC_pad, all_cents.shape[1]), np.float32)
    cents_p[:NC] = all_cents
    valid = np.arange(NC_pad) < NC

    minN, maxN = smetac_range(cfg.n_cells, cfg.minN_cluster, cfg.maxN_cluster, NC)
    maxN = min(maxN, NC - 1) if NC > 1 else 1
    if maxN < minN:  # the widened floor exceeds the problem (core/large.py)
        minN = max(2, maxN)
    ncand = max(maxN - minN + 1, 1)
    meta_nc_pad = ((min(maxN, NC) + 9) // 8) * 8
    with sub("smetac"):
        sres = smetac(
            torch.from_numpy(cents_p).to(device), torch.from_numpy(valid).to(device), NC, maxN,
            minN=minN, ncand=ncand, meta_nc_pad=meta_nc_pad,
            sil_thre=cfg.sil_thre, height_Ntimes=cfg.height_Ntimes,
            finalN_cluster=cfg.N_cluster, linkage_backend=cfg.linkage_backend,
        )
        tf = host_read(sres.tf, "streaming.global_tf").numpy()

    # global meta-cluster sizes from the summary counts, then the relabel
    # by decreasing size (R/SHARP_unlimited.R:179-183)
    offsets = np.concatenate([[0], np.cumsum([len(n) for _, n in summaries])])
    meta_sizes = np.zeros(int(tf.max()) + 1 if len(tf) else 1)
    np.add.at(meta_sizes, tf[: int(offsets[-1])], all_counts)
    present = np.nonzero(meta_sizes > 0)[0]
    order = present[np.argsort(-meta_sizes[present], kind="stable")]
    remap = np.zeros(len(meta_sizes), np.int32)
    remap[order] = np.arange(1, len(order) + 1)
    return tf, remap, offsets, order, meta_sizes


def sharp_unlimited(
    blocks: Union[Sequence[np.ndarray], str],
    *,
    n_cells: Optional[int] = None,
    n_genes: Optional[int] = None,
    manifest_dir: Optional[str] = None,
    resume: bool = True,
    multihost: bool = False,
    fuse_batch: int = 8,
    sparse_feed: Optional[bool] = None,
    group: Optional[int] = None,
    wire_dtype: str = "float32",
    device="cuda",
    rM: Optional[object] = None,
    **knobs,
) -> SharpResult:
    """Blocked / out-of-core clustering ~ SHARP_unlimited{,2,3} on `device`.

    `blocks` is a list of (cells, genes) blocks (numpy or scipy sparse) or
    a directory of block files (`io/blocks.BlockStore`; its manifest goes
    to `<dir>/.sharp_manifest` unless `manifest_dir` says otherwise, and
    finished blocks are reused when `resume`). A one-block list runs
    `sharp()` on the block. The sMetaC fuses of `fuse_batch` blocks are
    collected and run together (`core/large.fuse_blocks`: one call for the
    blocks of one shape), and their manifests written then (results do not
    depend on it).
    `sparse_feed` (default: on for SBLK files and scipy blocks) ships
    blocks to the device as CSR triplets and densifies there, with labels
    identical to the host densify (`False`); `wire_dtype="bfloat16"` also
    rounds the triplet values to bf16, a lossy opt-in. `group` bounds the
    folds per fold-program call (default: from free device memory,
    `parallel/sharded.auto_group`). The other knobs are those of `sharp`;
    `n_devices > 1` runs each block's folds over a mesh of devices.

    `rM` injects the K RP matrices every block shares (R/SHARP_unlimited.R
    draws them once, :96-105), as `sharp()`'s
    `rM` does: a list of K (genes, p) matrices or one stacked (genes,
    K * p) array, numpy or torch; by default they are drawn from
    `rN_seed` on `device`.

    Besides the labels, the result holds the large tier's diagnostics over
    the returned cells, in block order: `folds` (each cell's fold, numbered
    across the blocks), `per_member_k` and `per_member_maxsil` (T, K), and
    the block fuses' inputs: `fold_labels` (each cell's fold consensus),
    `fold_cent_sum` (T, nc_pad, p) and `fold_counts` (T, nc_pad), each
    fold's summary. These are None where a block was resumed from its
    manifest. `block_labels` holds each cell's cluster of its block's fuse
    (0..C_b - 1). `timing["fold_pass"]` adds up the feeds' host seconds
    (`parallel/sharded.FEED_KEYS`, and `SPARSE_FEED_KEYS` with the sparse
    feed), read with no synchronise.

    With `multihost=True`, each process of a `torch.distributed` group
    (torchrun's variables, `parallel/multihost.distributed_init`; one
    process without them) streams a disjoint contiguous slice of the
    blocks; one all-gather of the padded block summaries precedes the
    global sMetaC, which every process computes identically. The returned
    `pred_clusters` covers this process's blocks, in block order; the
    size-ordered relabelling comes from the global summary counts. On a
    card, `device="cuda"` is card LOCAL_RANK % device_count(). Processes
    that share a card divide its free memory among them.
    """
    from sharp_tpu_torch.api import resolve_device

    dev = resolve_device(device)
    timer = StageTimer("unlimited")

    # --- resolve input form ---------------------------------------------
    store: Optional[BlockStore] = None
    if isinstance(blocks, str):
        store = BlockStore(blocks)
        info = store.shape_info()
        files = store.files()
        n_blocks = len(files)
        if info:
            n_cells = n_cells or info["n_cells"]
            n_genes = n_genes or info["n_genes"]
        if manifest_dir is None:
            manifest_dir = os.path.join(blocks, ".sharp_manifest")
    else:
        blocks = list(blocks)
        if len(blocks) == 1:
            from sharp_tpu_torch.api import sharp

            b = blocks[0]
            # scipy sparse -> dense (np.asarray would wrap it 0-d)
            X1 = b.toarray() if hasattr(b, "tocsr") else np.asarray(b)
            return sharp(X1, rM=rM, device=dev, **knobs)
        n_blocks = len(blocks)
        n_cells = n_cells or sum(b.shape[0] for b in blocks)
        n_genes = n_genes or blocks[0].shape[1]
    if n_cells is None or n_genes is None:
        # one metadata pass over the files (the header only for SBLK);
        # values passed in are kept (n_cells may declare a larger dataset)
        from sharp_tpu_torch.io.native import read_header

        tot, gb = 0, None
        for f in files:
            if f.endswith(".sblk"):
                nb, gb, _, _ = read_header(f)
            else:
                nb, gb = BlockStore.load(f).shape
            tot += nb
        n_cells = n_cells or tot
        n_genes = n_genes or gb

    # the process group is joined before any device work, and the block
    # slice resolved first (the JAX package's order, :302-324)
    if multihost:
        from sharp_tpu_torch.parallel.multihost import barrier, block_slice, distributed_init, local_rank

        pidx, pcount = distributed_init()
        my_blocks = block_slice(n_blocks, pidx, pcount)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
        log(f"multihost: process {pidx}/{pcount} on {dev} handles blocks {my_blocks}")
        if pcount > 1:
            barrier(pcount)
    else:
        pidx, pcount = 0, 1
        my_blocks = list(range(n_blocks))
    lockstep = multihost and pcount > 1
    max_local = (n_blocks + pcount - 1) // pcount

    knobs.setdefault("forview", False)
    cfg = resolve_config(n_cells, n_genes, **knobs)
    # blocks are preprocessed upstream in the reference path (SHARP called
    # with prep=FALSE, logflag=FALSE -> log employed)
    logf = True if cfg.log_transform is None else bool(cfg.log_transform)
    rN_seed = resolve_seed(cfg.rN_seed)
    fingerprint = _config_fingerprint(cfg, wire_dtype)
    if manifest_dir:
        os.makedirs(manifest_dir, exist_ok=True)

    with timer.stage("rp_setup"):
        dtype = getattr(torch, cfg.dtype_compute)
        if rM is None:
            R_all = ensemble_rp_matrix(rN_seed, cfg.ensize_K, n_genes, cfg.reduced_ndim, dtype=dtype, device=dev)
        else:
            from sharp_tpu_torch.api import stack_rm

            R_all = stack_rm(rM, (n_genes, cfg.ensize_K * cfg.reduced_ndim)).to(dev, dtype)

    def load_block(i):
        from sharp_tpu_torch.io.sparse import SparseBlock

        if store is not None:
            f = files[i]
            if sparse_feed is not False and f.endswith(".sblk"):
                return SparseBlock.from_sblk(f)
            return BlockStore.load(f)
        b = blocks[i]
        if hasattr(b, "tocsr"):  # scipy sparse matrix
            sb = SparseBlock.from_scipy(b)
            return sb if sparse_feed is not False else sb.densify()
        return np.asarray(b, np.float32)

    def manifest_path(i):
        return os.path.join(manifest_dir, f"block_{i:05d}_{fingerprint}.npz") if manifest_dir else None

    def want(i):
        mp = manifest_path(i)
        return not (resume and mp and os.path.exists(mp))

    # --- per-block pass with prefetch + manifest resume ------------------
    from sharp_tpu_torch.parallel.mesh import resolve_mesh
    from sharp_tpu_torch.parallel.sharded import FEED_KEYS, SparsePipeline, sparse_plan

    mesh = resolve_mesh(cfg, dev)
    R_view = _view_rp_matrix(cfg, rN_seed, dev) if cfg.forview else None
    results_by_block = {}
    folds_by_block = {}   # block index -> its folds' diagnostics, where the block ran its fold pass
    pending = []  # (block index, fold summaries) awaiting their fuse
    feed = dict.fromkeys(FEED_KEYS, 0.0)

    def fuse_pending():
        if not pending:
            return
        fused = fuse_blocks([frs for _, frs in pending], cfg, device=dev)
        for (i, frs), fres in zip(pending, fused):
            labels, cents, counts, x0c = _block_summary(fres)
            viE_b = _block_view_features(frs, R_view) if cfg.forview else None
            mp = manifest_path(i)
            if mp:
                extra = {"x0": x0c, "viE": viE_b} if cfg.forview else {}
                np.savez(mp, labels=labels, cents=cents, counts=counts, **extra)
            results_by_block[i] = (labels, cents, counts, x0c, viE_b)
            log(f"block {i}: {len(labels)} cells -> {len(counts)} clusters")
        pending.clear()

    def plan_of(future):
        """What the sparse feed stages ahead for the prefetched block."""
        def plan():
            Xb = future.result()
            return sparse_plan(Xb, *_fold_layout(Xb, cfg), cfg, dev, mesh, group)
        return plan

    with timer.stage("block_pass"):
        with concurrent.futures.ThreadPoolExecutor(1) as pool, SparsePipeline(dev, wire_dtype) as pipe:
            future, prefetched_for = None, None
            for i in my_blocks:
                try:
                    if not want(i):
                        z = np.load(manifest_path(i))
                        results_by_block[i] = (
                            z["labels"], z["cents"], z["counts"],
                            z["x0"] if "x0" in z.files else None,
                            z["viE"] if "viE" in z.files else None,
                        )
                        log(f"block {i}: resumed from manifest")
                        continue
                    Xb = future.result() if prefetched_for == i else load_block(i)
                    # prefetch the next block still to run
                    nxt = next((j for j in my_blocks if j > i and want(j)), None)
                    future = pool.submit(load_block, nxt) if nxt is not None else None
                    prefetched_for = nxt
                    # the feed's worker stages that block's first group after this block's last
                    pipe.upcoming = plan_of(future) if future is not None else None
                    frs = _fold_pass(Xb, cfg, R_all, logf, dev, mesh, group=group, wire_dtype=wire_dtype,
                                     feed=feed, pipeline=pipe)
                    folds_by_block[i] = [{k: fr[k] for k in _FOLD_DIAGNOSTICS} for fr in frs]
                    pending.append((i, frs))
                    del Xb, frs
                    if len(pending) >= fuse_batch:
                        fuse_pending()
                finally:
                    if lockstep:
                        # once per block: no process reaches the summary
                        # all-gather more than one block ahead
                        barrier(pcount)
            fuse_pending()
        if lockstep:
            # a process with one block fewer runs the same number of barriers
            for _ in range(max_local - len(my_blocks)):
                barrier(pcount)
    block_results = [results_by_block[i] for i in my_blocks]

    with timer.stage("summary_gather"):
        if lockstep:
            summaries = _gather_summaries(block_results, cfg, n_blocks, pcount)
        else:
            summaries = [(c, n) for _, c, n, _x0, _v in block_results]

    # --- global sMetaC over block-cluster centroids ----------------------
    with timer.stage("global_smetac"):
        tf, remap, offsets, order, meta_sizes = global_block_fuse(summaries, cfg, dev)

    with timer.stage("finalize"):
        # every cell through its block's global offset
        n_glob = len(order)
        parts, viE_parts = [], []
        # x0 votes are summed column by column into one preallocated
        # (cells, n_glob) array
        x0_all = None
        if any(x0c is not None for _, _, _, x0c, _ in block_results):
            x0_all = np.zeros((sum(len(l) for l, *_ in block_results), n_glob), np.float32)
        row0 = 0
        for bi, (labels, _, _, x0c, viE_b) in zip(my_blocks, block_results):
            parts.append(remap[tf[offsets[bi] + labels]])
            if x0c is not None:
                # the block's vote columns onto their global size-ordered
                # clusters (as core/large._finish_block remaps fold x0)
                Cb = x0c.shape[1]
                gcol = remap[tf[offsets[bi] + np.arange(Cb)]] - 1
                rows = slice(row0, row0 + x0c.shape[0])
                for c in range(Cb):
                    x0_all[rows, gcol[c]] += x0c[:, c]
            row0 += len(labels)
            if viE_b is not None:
                viE_parts.append(viE_b)
        final = np.concatenate(parts).astype(np.int32) if parts else np.zeros((0,), np.int32)
        viE_all = np.concatenate(viE_parts, axis=0) if viE_parts else None
        vals = np.arange(1, n_glob + 1)  # global ids, size-ordered
        cnts = meta_sizes[order].astype(np.int64)
        diagnostics = _fold_diagnostics([folds_by_block.get(i) for i in my_blocks])
        block_labels = (np.concatenate([labels for labels, *_ in block_results]).astype(np.int32)
                        if block_results else None)

    return SharpResult(
        pred_clusters=final,
        N_pred_cluster=len(vals),
        unique_pred_clusters=[int(v) for v in vals],
        distr_pred_clusters={int(v): int(c) for v, c in zip(vals, cnts)},
        viE=viE_all,
        x0=x0_all,
        paras=cfg.as_dict(),
        timing={**timer.as_dict(), "fold_pass": feed},
        block_labels=block_labels,
        **diagnostics,
    )
