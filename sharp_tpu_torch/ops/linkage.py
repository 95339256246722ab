"""Agglomerative clustering over a padded distance matrix: plain versions.

Counterpart of `sharp_tpu/ops/linkage.py`. The reference bottoms out in
`stats::hclust(d, method="ward.D")` (R/get_opt_hclust.R:76-83). Here:

  * `ward_linkage` is the full-argmin Lance-Williams loop over (..., n, n)
    matrices, batched over the leading axes. All n_pad points take part;
    padded points carry the structural tiers of `ops/distance.py`, so every
    real merge happens before any padded one. The step picks the flat
    first-index argmin (smallest value, then row, then column) and records
    the merge as (min, max).
  * `cutree_multi` replays the merge sequence once and snapshots the labels
    at every candidate k in [minN, minN+ncand).
  * `ward_linkage_fast` and `ward_linkage_deferred` are the JAX package's
    serial ward.D entry points: the serial Ward kernel on the card
    (`ops/linkage_cuda.ward_linkage_serial`), `ward_linkage` on the CPU;
    the deferred one takes the other monotone hmethods through
    `ward_linkage`.
  * `ward_linkage_rnn` is the reciprocal-nearest-neighbour ladder for
    large problems: rounds merge every mutual-NN pair at once (`rnn_round`:
    `RnnLadder.round`, its scatter `rnn_round_scatter`, and the next
    round's row cache), a size ladder compacts the survivors, and
    `rnn_tail` drains the last compacted subproblem in strict serial order.

`ward_linkage`, `cutree_snapshots`, `rnn_round` and `rnn_tail` are the
plain versions of the hand-written kernels in `ops/linkage_cuda.py`
(`ward_linkage_serial`, `cutree_multi_kernel`, `rnn_round_kernel`,
`rnn_tail_kernel`): the CPU runs them, and the card's run is held against
them.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from sharp_tpu_torch.ops.distance import BIG
from sharp_tpu_torch.utils.timers import add, add_device, host_read, kernel, sub, tracing


class LinkageResult(NamedTuple):
    merges: torch.Tensor   # (..., n_pad - 1, 2) int32; col 0 = surviving (smaller) index
    heights: torch.Tensor  # (..., n_pad - 1) f32 merge distances (ward.D heights)


class CutForest(NamedTuple):
    labels: torch.Tensor   # (..., ncand, n_pad) int32 dense labels in [0, k); pads -> nc_pad-1
    k: torch.Tensor        # (..., ncand) int32 actual cluster count per candidate
    valid: torch.Tensor    # (..., ncand) bool — candidate k is testable


# Lance-Williams update coefficients for every hmethod the reference's
# hclust call accepts (R/get_opt_hclust.R:77). Each operation is its own
# rounded float32 op, in this association order; the CUDA kernel computes
# ward.D with the same order and no fused multiply-add.
def lw_update(method: str, dik, djk, h, ni, nj, nk):
    if method in ("ward.D", "ward.D2", "ward"):
        return ((ni + nk) * dik + (nj + nk) * djk - nk * h) / (ni + nj + nk)
    if method == "single":
        return torch.minimum(dik, djk)
    if method == "complete":
        return torch.maximum(dik, djk)
    if method == "average":
        return (ni * dik + nj * djk) / (ni + nj)
    if method == "mcquitty":
        return 0.5 * dik + 0.5 * djk
    if method == "median":
        return 0.5 * dik + 0.5 * djk - 0.25 * h
    if method == "centroid":
        s = ni + nj
        return (ni * dik + nj * djk) / s - (ni * nj * h) / (s * s)
    raise ValueError(f"unknown hmethod {method!r}")


MONOTONE_METHODS = frozenset(
    {"ward.D", "ward.D2", "ward", "single", "complete", "average", "mcquitty"}
)

HMETHODS = (
    "ward.D", "ward.D2", "single", "complete", "average", "mcquitty",
    "median", "centroid",
)

# "auto" and "pallas" take serial Ward up to this padded size and the f32
# ladder above it
SERIAL_MAX_N = 1024


def resolve_linkage_backend(backend: str, n_pad: int, hmethod: str = "ward.D") -> str:
    """Map `SharpConfig.linkage_backend` to the port's linkage for a problem
    of padded size n_pad: "serial" / "serial_bf16" (ward.D through the
    serial Ward kernel with f32 / bf16 matrix storage on a CUDA tensor, its
    plain loop on a CPU tensor), "rnn" / "rnn_bf16" (the reciprocal-NN
    ladder with f32 / bf16 matrix storage) or "plain" (the full-argmin
    loop, for the other hmethods on both devices).

    "auto", "xla" and "pallas" name the exact serial f32 merge order: the
    serial kernel up to n_pad 1024, above that the ladder with f32 storage
    (its merges are the serial ones on tie-free data). "rnn" and
    "rnn_bf16" take the ladder at every size. "pallas_bf16" takes serial
    Ward with bf16 storage at every size, as the JAX package does (its
    merge order, not the ladder's).
    """
    if hmethod not in HMETHODS:
        raise ValueError(f"unknown hmethod {hmethod!r}")
    if backend not in ("auto", "xla", "pallas", "pallas_bf16", "rnn", "rnn_bf16"):
        raise ValueError(f"unknown linkage backend {backend!r}")
    if hmethod != "ward.D":
        if backend not in ("auto", "xla"):
            raise ValueError(
                f"linkage backend {backend!r} implements ward.D only; "
                f"hmethod {hmethod!r} requires backend='xla' (or 'auto')"
            )
        return "plain"
    if backend in ("rnn", "rnn_bf16"):
        return backend
    if backend == "pallas_bf16":
        return "serial_bf16"
    return "serial" if n_pad <= SERIAL_MAX_N else "rnn"


def ward_linkage(
    D: torch.Tensor, method: str = "ward.D", store_dtype: Optional[torch.dtype] = None
) -> LinkageResult:
    """Agglomeration over padded distance matrices D (..., n, n), any hmethod.

    The first n_real - 1 merges of each problem are exactly the merges of
    the unpadded problem, in R's hclust order. This full-argmin loop is the
    semantic reference and is right for every method, including the
    non-monotone centroid/median recurrences.

    D is read as symmetric, from its upper triangle. `store_dtype`
    (default D's dtype; float32 or bfloat16 for a float32 D) is the matrix
    storage of the JAX package's `ward_linkage_pallas(store_dtype=...)`:
    D is rounded to it on entry, every row is read as stored values, the
    update runs in D's dtype and the new row is rounded on store, so the
    argmin and the heights see stored values only.
    """
    n = D.shape[-1]
    batch = D.shape[:-2]
    Db = D.reshape(-1, n, n)
    B = Db.shape[0]
    dev = Db.device
    st = store_dtype if store_dtype is not None else D.dtype
    if st != D.dtype and (D.dtype, st) != (torch.float32, torch.bfloat16):
        raise TypeError(f"ward_linkage stores {D.dtype} D as {D.dtype} or bfloat16, got {st}")
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    # a fresh matrix, symmetric from the upper triangle: the loop below
    # updates it in place
    upper = torch.triu(Db, 1)
    Db = _store_round(torch.where(eye, BIG, upper + upper.transpose(1, 2)), st)
    ar = torch.arange(n, device=dev)
    bidx = torch.arange(B, device=dev)
    active = torch.ones((B, n), dtype=torch.bool, device=dev)
    sizes = torch.ones((B, n), dtype=Db.dtype, device=dev)
    merges = torch.zeros((B, n - 1, 2), dtype=torch.int32, device=dev)
    heights = torch.zeros((B, n - 1), dtype=Db.dtype, device=dev)
    big = _store_round(torch.tensor(BIG, dtype=Db.dtype, device=dev), st)
    flat = Db.view(B, n * n)
    for t in range(n - 1):
        idx = torch.argmin(flat, dim=1)          # first index of the flat min
        i0 = idx // n
        j0 = idx % n
        i = torch.minimum(i0, j0)
        j = torch.maximum(i0, j0)
        h = flat[bidx, idx]
        ni = sizes[bidx, i][:, None]
        nj = sizes[bidx, j][:, None]
        dik = Db[bidx, i]
        djk = Db[bidx, j]
        formula = lw_update(method, dik, djk, h[:, None], ni, nj, sizes)
        valid = active & (ar[None, :] != i[:, None]) & (ar[None, :] != j[:, None])
        newrow = _store_round(torch.where(valid, formula, big), st)
        Db[bidx, i, :] = newrow
        Db[bidx, :, i] = newrow
        Db[bidx, j, :] = big
        Db[bidx, :, j] = big
        active[bidx, j] = False
        sizes[bidx, i] = ni[:, 0] + nj[:, 0]
        merges[:, t, 0] = i.to(torch.int32)
        merges[:, t, 1] = j.to(torch.int32)
        heights[:, t] = h
    return LinkageResult(
        merges=merges.reshape(*batch, n - 1, 2),
        heights=heights.reshape(*batch, n - 1),
    )


def ward_linkage_fast(D: torch.Tensor) -> LinkageResult:
    """ward.D agglomeration of float32 D (n, n), or of a batch (K, n, n),
    with float32 storage: the port of `sharp_tpu/ops/linkage.py:
    ward_linkage_fast`.

    The JAX function replaces the full argmin of `ward_linkage` by a lazy
    row-minimum cache, with the same output. So does the serial Ward
    kernel, which this takes on a CUDA tensor (`ops.linkage_cuda.
    ward_linkage_serial`, counted in `LAUNCHES["ward_serial"]`); a CPU
    tensor takes `ward_linkage(D, "ward.D")`. Both give the same merges and
    heights, bit for bit. D is read as symmetric from its upper triangle
    (the JAX function reads all of it: the same for the symmetric D that
    every caller passes).
    """
    from sharp_tpu_torch.ops.linkage_cuda import ward_linkage_serial

    return ward_linkage_serial(D.contiguous(), store_dtype=torch.float32)


def ward_linkage_deferred(
    D: torch.Tensor, flush: int = 64, unroll: int = 1, eager_w: int = 0,
    method: str = "ward.D",
) -> LinkageResult:
    """Agglomeration of D (n, n), or a batch (K, n, n), for a monotone
    hmethod: the port of `sharp_tpu/ops/linkage.py:ward_linkage_deferred`,
    the linkage the JAX package's `opt_hclust` takes for every monotone
    hmethod.

    ward.D takes `ward_linkage_fast`: the serial Ward kernel on a CUDA
    tensor, `ward_linkage` on a CPU tensor. The other methods of
    `MONOTONE_METHODS` take `ward_linkage(D, method)` on either device: no
    kernel computes them, in the JAX package either (its Pallas kernel is
    ward.D only). A non-monotone method raises, as in the JAX package.

    `flush` (the dirty-column epoch), `unroll` and `eager_w` (the eager
    revalidation width) shape the JAX function's XLA loop and not its
    output, so they leave this one's unchanged; they are checked where
    the JAX function would fail (a flush that is not an int >= 1, a width
    that is not an int). D is read as symmetric from its upper triangle,
    as in `ward_linkage_fast`.
    """
    if method not in MONOTONE_METHODS:
        raise ValueError(f"hmethod {method!r} is non-monotone; use ward_linkage instead")
    for name, v in (("flush", flush), ("unroll", unroll), ("eager_w", eager_w)):
        if not isinstance(v, (int, np.integer)):
            raise TypeError(f"ward_linkage_deferred takes an int {name}, got {v!r}")
    if flush < 1:
        raise ValueError(f"ward_linkage_deferred takes flush >= 1, got {flush}")
    if method == "ward.D":
        return ward_linkage_fast(D)
    return ward_linkage(D, method=method)


def _store_round(x: torch.Tensor, st: torch.dtype) -> torch.Tensor:
    """x rounded to the storage dtype and read back in x's dtype: bf16
    rounds to nearest even, as the JAX package's `lax.reduce_precision(x,
    8, 7)` and its `.astype(jnp.bfloat16)`."""
    return x if st == x.dtype else x.to(st).to(x.dtype)


def rnn_tail(
    D: torch.Tensor, alive: torch.Tensor, sizes: torch.Tensor,
    gidx: torch.Tensor, lasth: torch.Tensor,
):
    """Serial-drain the ladder's compacted subproblems, L lanes at once.

    Plain version of `rnn_tail_kernel`, with the arithmetic and the tie
    rule of the TPU kernel (`_rnn_tail_kernel`,
    sharp_tpu/ops/linkage_pallas.py:496-562). Every step merges each lane's
    flat first-index minimum pair (smallest value, then row, then column),
    writes the Lance-Williams row and column in D's storage dtype, and
    records (gidx[i], gidx[j]) with the height clamped to
    max(h, lasth[i], lasth[j]), which becomes lasth[i].

    D (L, Cn, Cn) float32 or bfloat16 with BIG on the diagonal and in dead
    slots; alive (L, Cn) (1/0 or bool), sizes and lasth (L, Cn) float32,
    gidx (L, Cn) integer. Returns mi, mj (L, Cn) int32 and hh (L, Cn)
    float32; entry t of a lane is its t-th merge, and entries
    t >= n_alive - 1 are garbage the caller masks.
    """
    L, Cn, _ = D.shape
    dev = D.device
    st = D.dtype
    W = D.to(torch.float32, copy=True)        # the stored values, read as f32
    act = alive > 0.5 if alive.dtype != torch.bool else alive.clone()
    sz = sizes.to(torch.float32, copy=True)
    lh = lasth.to(torch.float32, copy=True)
    gi = gidx.to(torch.int32)
    mi = torch.zeros((L, Cn), dtype=torch.int32, device=dev)
    mj = torch.zeros((L, Cn), dtype=torch.int32, device=dev)
    hh = torch.zeros((L, Cn), dtype=torch.float32, device=dev)
    if L == 0:
        return mi, mj, hh
    lanes = torch.arange(L, device=dev)
    ar = torch.arange(Cn, device=dev)
    big = _store_round(torch.tensor(BIG, dtype=torch.float32, device=dev), st)
    for t in range(int(act.sum(dim=1).max()) - 1):
        rowmin = W.amin(dim=2)
        m = rowmin.amin(dim=1, keepdim=True)
        i0 = torch.where(rowmin == m, ar, Cn).amin(dim=1)
        rowi = W[lanes, i0.clamp(max=Cn - 1)]
        j0 = torch.where((rowi == m) & (ar != i0[:, None]), ar, Cn).amin(dim=1)
        i = torch.minimum(i0, j0).clamp(max=Cn - 1)
        j = torch.maximum(i0, j0).clamp(max=Cn - 1)
        h = m
        ni = sz[lanes, i][:, None]
        nj = sz[lanes, j][:, None]
        formula = ((ni + sz) * W[lanes, i] + (nj + sz) * W[lanes, j] - sz * h) / (ni + nj + sz)
        valid = act & (ar != i[:, None]) & (ar != j[:, None])
        newrow = _store_round(torch.where(valid, formula, big), st)
        W[lanes, i] = newrow
        W[lanes, :, i] = newrow
        W[lanes, j] = big
        W[lanes, :, j] = big
        act[lanes, j] = False
        sz[lanes, i] = (ni + nj)[:, 0]
        hrec = torch.maximum(h[:, 0], torch.maximum(lh[lanes, i], lh[lanes, j]))
        lh[lanes, i] = hrec
        mi[:, t] = gi[lanes, i]
        mj[:, t] = gi[lanes, j]
        hh[:, t] = hrec
    return mi, mj, hh


def _round_scatter_(W, rows, colslot, dying) -> None:
    """One ladder round's scatter, in place on W (L, m, m): a dying row or
    column becomes BIG; the survivor row r becomes rows[colslot[r], :] and
    the survivor column c of any other row r becomes rows[colslot[c], r];
    every other entry keeps its value."""
    L, m, _ = W.shape
    cola = colslot >= 0
    cs = colslot.clamp_min(0).long()
    full = rows.gather(1, cs[:, :, None].expand(L, m, m))   # full[l, r, c] = rows[l, cs[r], c]
    torch.where(cola[:, None, :], full.transpose(1, 2), W, out=W)
    torch.where(cola[:, :, None], full, W, out=W)
    del full
    dy = dying.bool()
    W.masked_fill_(dy[:, :, None] | dy[:, None, :], torch.tensor(BIG, dtype=W.dtype, device=W.device))


def rnn_round_scatter(
    W: torch.Tensor, rows: torch.Tensor, colslot: torch.Tensor, dying: torch.Tensor
):
    """One ladder round's scatter and the next round's row cache: what the
    TPU kernel `_round_scatter_kernel` computes
    (sharp_tpu/ops/linkage_pallas.py:683-758).

    W (L, m, m) float32 or bfloat16 storage is updated in place (see
    `_round_scatter_`); rows (L, P, m) in W's dtype are the pairs' fresh
    rows, colslot (L, m) integer holds -1 or the pair slot whose survivor
    is column c, dying (L, m) bool or 0/1 marks the clusters merged away.
    Returns rowmin (L, m) float32 and rowarg (L, m) int64: each row's
    minimum over the stored values and the first index that holds it.
    """
    _round_scatter_(W, rows, colslot, dying)
    rowmin, rowarg = W.min(dim=2)
    return rowmin.float(), rowarg


ROUND_IMPLS = ("auto", "xla", "pallas", "pallas_interpret")
TAILS = ("auto", "xla", "pallas", "pallas_interpret")
# rounds the level loop of `rnn_ladder` runs between two host reads
LADDER_READ_EVERY = 8


def _round_fused(round_impl: str) -> bool:
    """Whether the ladder's rounds go through the round kernel: "auto",
    "pallas" and "pallas_interpret" (the JAX package's interpreted kernel,
    for its CPU tests) do (`rnn_round_kernel`, which takes its plain
    version `rnn_round` for a CPU tensor); "xla" keeps the rounds in plain
    PyTorch, each round computing its row cache from the matrix."""
    if round_impl not in ROUND_IMPLS:
        raise ValueError(f"unknown round_impl {round_impl!r} (one of {ROUND_IMPLS})")
    return round_impl != "xla"


def _append(merges, heights, cnt, ga, gb, hrec, valid) -> None:
    """Write the merges (ga, gb, hrec) (L, S) of the valid slots into
    merges (L, n, 2) / heights (L, n) at each lane's offset cnt, in slot
    order; the other slots write to the discard slot n - 1."""
    S = ga.shape[1]
    pos = cnt[:, None] + torch.arange(S, device=ga.device)
    pos = torch.where(valid, pos, merges.shape[1] - 1)
    ents = torch.stack([ga, gb], dim=-1).to(torch.int32)
    merges.scatter_(1, pos[:, :, None].expand(-1, -1, 2), ents)
    heights.scatter_(1, pos, hrec)


class RnnLadder:
    """Per-lane state of the reciprocal-NN ladder (`rnn_ladder`): the
    current level's matrix and cluster state, and the merges recorded so
    far."""

    def __init__(self, D: torch.Tensor, st: torch.dtype):
        L, n, _ = D.shape
        dev = D.device
        self.n = n
        self.D = torch.where(torch.eye(n, dtype=torch.bool, device=dev), BIG, D).to(st)
        self.big = torch.tensor(BIG, dtype=st, device=dev)
        self.alive = torch.ones((L, n), dtype=torch.bool, device=dev)
        self.sizes = torch.ones((L, n), dtype=torch.float32, device=dev)
        self.gidx = torch.arange(n, device=dev).repeat(L, 1)   # global cluster of each slot
        self.lasth = torch.zeros((L, n), dtype=torch.float32, device=dev)
        # n - 1 merge records and, at n - 1, one slot that absorbs the
        # writes of empty pair slots: (gidx[0], gidx[0]) = (0, 0) and BIG
        # after the first round with an empty slot (slot 0 never dies)
        self.merges = torch.zeros((L, n, 2), dtype=torch.int32, device=dev)
        self.heights = torch.zeros((L, n), dtype=torch.float32, device=dev)
        self.cnt = torch.zeros(L, dtype=torch.long, device=dev)
        self.rounds = torch.zeros(L, dtype=torch.long, device=dev)
        # (rowmin float32, rowarg int64) of D, carried from a kernel round to
        # the next; None makes `row_cache` compute it from D
        self.rowcache = None
        # the round kernel's pair buffers (`rnn_round_kernel`), kept for the
        # rounds of a level
        self.scratch = None
        # host reads of `rnn_ladder`'s level loop, and each finished level's
        # rounds, the most any lane took (a (0-d) tensor on the device)
        self.host_reads = 0
        self.level_rounds = []

    def tail_inputs(self):
        """(D, alive, sizes, gidx, lasth) of the compacted subproblem, as
        `rnn_tail` / `rnn_tail_kernel` take them."""
        return self.D, self.alive.float(), self.sizes, self.gidx.to(torch.int32), self.lasth

    def finish(self, mi, mj, hh) -> LinkageResult:
        """The whole merge sequence, (L, n-1, 2) and (L, n-1): the ladder's
        merges and the tail's (mi, mj, hh) for t < n_alive - 1, sorted
        stably by recorded height. Leaves the ladder as it is."""
        L, n = self.merges.shape[0], self.n
        merges, heights = self.merges.clone(), self.heights.clone()
        steps = torch.arange(mi.shape[1], device=mi.device)[None, :]
        _append(merges, heights, self.cnt, mi, mj, hh, steps < self.alive.sum(dim=1, keepdim=True) - 1)
        heights, order = torch.sort(heights[:, : n - 1], dim=1, stable=True)
        merges = merges[:, : n - 1].gather(1, order[:, :, None].expand(L, n - 1, 2))
        return LinkageResult(merges, heights)

    def active(self, nxt: int) -> torch.Tensor:
        """(L,) bool, on the device: the lanes that take a round toward a
        level of at most nxt clusters, those with merges left, more than nxt
        clusters alive and fewer than n rounds at this level (the JAX
        package's `cond_lvl`, sharp_tpu/ops/linkage.py:830-832). A lane
        leaves and does not come back within a level."""
        return (self.cnt < self.n - 1) & (self.alive.sum(dim=1) > nxt) & (self.rounds < self.n)

    def row_cache(self):
        """(rowmin float32, rowarg int64): each row's minimum over the
        stored values and the first index that holds it, carried from the
        previous kernel round or computed from D."""
        if self.rowcache is None:
            rowmin, rowarg = self.D.min(dim=2)
            self.rowcache = (rowmin.float(), rowarg)
        return self.rowcache

    def round(self, active: torch.Tensor, P: int) -> None:
        """One round on the lanes flagged `active`, in plain PyTorch: merge
        up to P mutual nearest-neighbour pairs per lane
        (sharp_tpu/ops/linkage.py:612-767, with the one-hot contractions
        written as direct indexing).

        The row minima and first-index argmins come from `row_cache`; the
        scatter is `_round_scatter_`, after which the next round reads D
        again. Frozen lanes have no pairs: the scatter leaves their rows as
        they are. A round on which no lane is active changes nothing but
        the discard slot n - 1 of merges and heights, which it sets to (0,
        0) and BIG as every round with an empty pair slot does; `finish`
        drops that slot.
        """
        W = self.D
        L, m, _ = W.shape
        dev = W.device
        st = W.dtype
        ar = torch.arange(m, device=dev)
        arP = torch.arange(P, device=dev)
        rowmin, nn = self.row_cache()
        mutual = (nn.gather(1, nn) == ar) & self.alive & (rowmin < 0.5 * BIG)
        lead = mutual & (ar < nn) & active[:, None]
        # the first P leads of each lane, in index order
        rank = lead.cumsum(dim=1) - 1
        slot = torch.where(lead & (rank < P), rank, P)
        a = torch.zeros((L, P + 1), dtype=torch.long, device=dev)
        a = a.scatter_(1, slot, ar.expand(L, m))[:, :P]
        n_pairs = lead.sum(dim=1).clamp(max=P)
        sv = arP[None, :] < n_pairs[:, None]
        b = torch.where(sv, nn.gather(1, a), 0)
        svf = sv.float()
        na = self.sizes.gather(1, a) * svf
        nb = self.sizes.gather(1, b) * svf
        h = torch.where(sv, rowmin.gather(1, a), BIG)

        Da = W.gather(1, a[:, :, None].expand(L, P, m)).float()
        Db = W.gather(1, b[:, :, None].expand(L, P, m)).float()
        nk = self.sizes[:, None, :]
        newrows = (
            (na[:, :, None] + nk) * Da + (nb[:, :, None] + nk) * Db - nk * h[:, :, None]
        ) / ((na + nb)[:, :, None] + nk)
        del Da, Db
        rows_st = newrows.to(st)
        rows_rt = rows_st.float()
        # pair-pair entries: the later merge's Lance-Williams step applied to
        # the earlier merge's stored fresh row (the serial association)
        Ra = rows_rt.gather(2, a[:, None, :].expand(L, P, P))
        Rb = rows_rt.gather(2, b[:, None, :].expand(L, P, P))
        ne = na + nb
        E = (
            (na[:, None, :] + ne[:, :, None]) * Ra
            + (nb[:, None, :] + ne[:, :, None]) * Rb
            - ne[:, :, None] * h[:, None, :]
        ) / torch.clamp_min((na + nb)[:, None, :] + ne[:, :, None], 1e-9)
        hp, hq = h[:, :, None], h[:, None, :]
        earlier = (hp < hq) | ((hp == hq) & (a[:, :, None] < a[:, None, :]))
        V = torch.where(earlier, E, E.transpose(1, 2)).to(st)

        # colslot[l, c]: the pair slot whose survivor is column c, or -1
        colslot = torch.full((L, m + 1), -1, dtype=torch.long, device=dev)
        colslot = colslot.scatter_(1, torch.where(sv, a, m), arP.expand(L, P))[:, :m]
        cola = colslot >= 0
        cs = colslot.clamp_min(0)
        dying = torch.zeros((L, m + 1), dtype=torch.bool, device=dev)
        dying = dying.scatter_(1, torch.where(sv, b, m), torch.ones_like(sv))[:, :m]
        rows_st = torch.where(cola[:, None, :], V.gather(2, cs[:, None, :].expand(L, P, m)), rows_st)
        selfm = (ar == a[:, :, None]) | (ar == b[:, :, None])
        rows_st = torch.where(
            selfm | dying[:, None, :] | ~self.alive[:, None, :], self.big, rows_st
        )

        # survivors' rows and columns take their fresh rows; dying ones die
        _round_scatter_(W, rows_st, colslot, dying)
        self.rowcache = None
        self.alive = self.alive & ~dying
        self.sizes = self.sizes + torch.where(cola, nb.gather(1, cs), 0.0)

        # recorded height: clamped to the merging clusters' earlier records,
        # so the final stable height sort stays topological under rounding
        hrec = torch.maximum(h, torch.maximum(self.lasth.gather(1, a), self.lasth.gather(1, b)))
        hrec = torch.where(sv, hrec, BIG)
        self.lasth = torch.where(cola, hrec.gather(1, cs), self.lasth)
        _append(self.merges, self.heights, self.cnt,
                self.gidx.gather(1, a), self.gidx.gather(1, b), hrec, sv)
        self.cnt += n_pairs
        self.rounds += active.long()

    def compact(self, Cn: int) -> None:
        """Gather each lane's <= Cn survivors, in index order, into a
        (Cn, Cn) subproblem (sharp_tpu/ops/linkage.py:786-815)."""
        W = self.D
        L, m, _ = W.shape
        dev = W.device
        ar = torch.arange(m, device=dev)
        arC = torch.arange(Cn, device=dev)
        n_alive = self.alive.sum(dim=1)
        rank = self.alive.cumsum(dim=1) - 1
        slot = torch.where(self.alive & (rank < Cn), rank, Cn)
        surv = torch.zeros((L, Cn + 1), dtype=torch.long, device=dev)
        surv = surv.scatter_(1, slot, ar.expand(L, m))[:, :Cn]
        svC = arC[None, :] < n_alive[:, None]
        D2 = W.gather(1, surv[:, :, None].expand(L, Cn, m))
        D2 = D2.gather(2, surv[:, None, :].expand(L, Cn, Cn))
        keep = svC[:, :, None] & svC[:, None, :] & (arC[:, None] != arC[None, :])
        self.D = torch.where(keep, D2, self.big)
        self.alive = svC
        self.sizes = torch.where(svC, self.sizes.gather(1, surv), 1.0)
        self.gidx = torch.where(svC, self.gidx.gather(1, surv), 0)
        self.lasth = torch.where(svC, self.lasth.gather(1, surv), 0.0)
        self.level_rounds.append(self.rounds.max())
        self.rounds.zero_()
        self.rowcache = None
        self.scratch = None


def rnn_round(ladder: RnnLadder, nxt: int, P: int) -> None:
    """One round of the ladder toward a level of at most nxt clusters, in
    place: `RnnLadder.round` on the lanes `RnnLadder.active(nxt)` flags, up
    to P pairs a lane, then the next round's row cache. Plain version of
    `rnn_round_kernel`."""
    ladder.round(ladder.active(nxt), P)
    ladder.row_cache()


def _read_every(D: torch.Tensor, fused: bool) -> int:
    """Rounds of `rnn_ladder`'s level loop between two host reads: the card's
    round kernel, which returns at once when no lane is active, reads every
    `LADDER_READ_EVERY` rounds; plain rounds (the CPU, round_impl "xla"),
    which do the whole round's work even then and whose read costs little,
    read every round."""
    return LADDER_READ_EVERY if fused and D.is_cuda else 1


def rnn_ladder(
    D: torch.Tensor,
    pair_cap: int = 128,
    store_dtype: Optional[torch.dtype] = None,
    compact_n: int = 256,
    round_impl: str = "auto",
) -> RnnLadder:
    """The rounds of the reciprocal-NN ladder over D (L, n, n), down to the
    compacted subproblem of at most `compact_n` clusters per lane that the
    tail drains (sharp_tpu/ops/linkage.py:817-837). `round_impl` picks the
    rounds (`_round_fused`).

    Ward's recurrence is reducible, so every mutual-NN pair can merge in
    one round. At each level, rounds run only until a lane's survivors fit
    the next (half-size) level; then the survivors are compacted. The L
    lanes behave as separate calls: a lane that already fits the next level
    takes no more rounds while others do (a vmapped while loop in the JAX
    package). Whether any lane goes on is computed on the device and read
    by the host once before a level's first round and then once every k
    rounds (`_read_every`; `RnnLadder.host_reads` counts the reads): a
    round on which no lane is active changes nothing, so the merges are
    those of a read before every round, and at most k - 1 rounds a level
    run with every lane inactive.
    """
    L, n, _ = D.shape
    st = store_dtype if store_dtype is not None else D.dtype
    if st not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the ladder stores float32 or bfloat16, got {st}")
    fused = _round_fused(round_impl)
    if fused:
        from sharp_tpu_torch.ops import linkage_cuda
    read_every = _read_every(D, fused)
    C = min(compact_n, n)
    s = RnnLadder(D, st)
    traced = tracing()
    merged = 0      # merges before the level, on the device while tracing
    lvl = n
    while lvl > C:
        nxt = max(lvl // 2, C)
        P = min(pair_cap, lvl // 2)
        launched = 0
        with sub(f"level{lvl}"):
            while True:
                s.host_reads += 1
                if not host_read(s.active(nxt).any(), "ladder.active"):
                    break
                for _ in range(read_every):
                    if fused:
                        linkage_cuda.rnn_round_kernel(s, nxt, P)
                    else:
                        s.round(s.active(nxt), P)
                launched += read_every
            if traced:
                merged = _count_level(s, lvl, nxt, P, launched, fused, merged)
            s.compact(nxt)
        lvl = nxt
    return s


def _count_level(s: RnnLadder, m: int, nxt: int, P: int, launched: int, fused: bool, merged):
    """The tracer's sums of a finished level of m clusters, before its
    compaction, with no host read: the lane-rounds launched and those in
    which a lane was active (`rounds`), and with the round kernel, the
    bytes its rounds must move by `chip_smoke.round_bytes`' rule, each input
    read once and each output written once, bounded from below where the
    count needs a round's matrices before and after it. Every active lane
    merges at least one pair (the first-index minimum of its matrix is a
    mutual pair), so the live lanes are the active ones. Per launched
    lane-round: alive flags, cnt and rounds read; per active lane-round: the
    row cache read (12 B an entry) and the sizes (4 B), the counters
    written; per pair: rows a and b read, lasth, gidx read and lasth,
    alive, merges, heights, sizes written (45 B), and the entries known to
    change: the dying row's to the >= nxt other clusters alive before the
    round, and the dying column's in the >= (nxt + 1) / 2 rows alive after
    it. Left out: the rows read again, the survivors' changed entries and
    the changed row cache. Also the pairs the rounds merged and the pair
    slots they had, P an active lane-round. `merged`: the merges before the
    level; returns those after it."""
    L = s.D.shape[0]
    active = s.rounds.sum()
    total = s.cnt.sum()
    pairs = total - merged
    add("ladder.launched_lane_rounds", L * launched)
    add_device("ladder.live_lane_rounds", active)
    add_device("ladder.pairs", pairs)
    add_device("ladder.pair_slots", P * active)
    if fused:
        es = s.D.element_size()
        add("rnn_round.bytes", L * launched * (m + 16))
        add_device("rnn_round.bytes", active * (16 * m + 16)
                   + pairs * (2 * m * es + 45 + (nxt + (nxt + 2) // 2) * es))
    return total


def ward_linkage_rnn(
    D: torch.Tensor,
    pair_cap: int = 128,
    store_dtype: Optional[torch.dtype] = None,
    compact_n: int = 256,
    compact_cap: int = 32,
    tail: str = "auto",
    round_impl: str = "auto",
) -> LinkageResult:
    """ward.D agglomeration by reciprocal-nearest-neighbour rounds over D
    (L, n, n) or (n, n): the port of `sharp_tpu/ops/linkage.py:
    ward_linkage_rnn`.

    `rnn_ladder` runs the rounds; the compacted subproblem is drained in
    strict serial order by the tail; the serial order is recovered by a
    stable sort on the recorded heights, which are clamped to each
    cluster's previous record.

    `tail` takes the JAX package's names: "auto", "pallas" and
    "pallas_interpret" drain through `rnn_tail_kernel` (the plain
    `rnn_tail` for a CPU tensor); "xla" takes the plain `rnn_tail` on
    either device, the counterpart of the JAX package's XLA tail (its
    mutual-NN rounds give the same merges after the stable sort).

    `store_dtype` (float32 or bfloat16, default D's dtype) is the matrix
    storage; the Lance-Williams arithmetic stays float32. `round_impl`
    takes the JAX package's names: "xla" keeps the rounds in plain
    PyTorch; "pallas" runs each round through `rnn_round_kernel` (its
    plain version on a CPU tensor), which also carries the row cache to
    the next round; "pallas_interpret" is "pallas"; "auto" is "pallas"
    (the TPU kept its fused round opt-in for a cost of its own compiler,
    which does not apply here). The output is identical either way.
    `compact_cap` is accepted for signature parity: it sizes the JAX
    package's round-based tail, which the serial tail replaces. While
    tracing on a card, `timers.kernel("ladder")` times the rounds and the
    tail together.
    """
    from sharp_tpu_torch.ops.linkage_cuda import rnn_tail_kernel

    if tail not in TAILS:
        raise ValueError(f"unknown tail {tail!r} (one of {TAILS})")
    drain = rnn_tail if tail == "xla" else rnn_tail_kernel
    squeeze = D.dim() == 2
    with kernel("ladder") if D.is_cuda else contextlib.nullcontext():
        ladder = rnn_ladder(D[None] if squeeze else D, pair_cap, store_dtype, compact_n, round_impl)
        with sub("tail"):
            tail_out = drain(*ladder.tail_inputs())
    link = ladder.finish(*tail_out)
    return LinkageResult(link.merges[0], link.heights[0]) if squeeze else link


def validate_merge_sequence(merges, heights, n_real: int, n_pad: int) -> List[str]:
    """Host-side structural check of one merge sequence; empty when valid.

    Index range, self-merges, duplicated pairs, replay viability (every
    merged-away j must be a live representative) and height monotonicity
    over the real merges (`sharp_tpu/ops/linkage.py:validate_merge_sequence`).
    """
    if isinstance(merges, torch.Tensor):
        merges = merges.cpu().numpy()
    if isinstance(heights, torch.Tensor):
        heights = heights.float().cpu().numpy()
    errs = []
    m = np.asarray(merges)[: n_pad - 1]
    h = np.asarray(heights)[: n_pad - 1]
    if (m < 0).any() or (m >= n_pad).any():
        errs.append(f"indices out of range [0,{n_pad}): min={m.min()} max={m.max()}")
        return errs
    n_self = int((m[:, 0] == m[:, 1]).sum())
    if n_self:
        errs.append(f"{n_self} self-merges")
    pairs = {(int(a), int(b)) for a, b in m}
    if len(pairs) < len(m):
        errs.append(f"{len(m) - len(pairs)} duplicated pairs")
    lab = np.arange(n_pad)
    viol = 0
    for a, b in m:
        if not (lab == b).any():
            viol += 1
        lab[lab == b] = a
    if viol:
        errs.append(f"{viol} replay violations (merged-away index reused)")
    hr = h[: n_real - 1]
    drops = int((np.diff(hr) < -1e-5 * np.maximum(np.abs(hr[:-1]), 1e-9)).sum())
    if drops:
        errs.append(f"{drops} height-order drops in real merges")
    return errs


def densify_labels(lab: torch.Tensor, real_mask: torch.Tensor, nc_pad: int):
    """Map representative-index labels (..., n) to dense ids 0..k-1 in
    first-index order; padded cells go to the reserved garbage slot
    nc_pad - 1. Returns (dense int32, k int32).

    A replay representative carries its own index (merges relabel j -> i
    with i < j), so occupancy is `lab == arange`. Representatives past the
    first nc_pad get dense id 0, as in the JAX package's compare form.
    """
    n = lab.shape[-1]
    ar = torch.arange(n, device=lab.device)
    occ = (lab == ar) & real_mask
    k = occ.sum(dim=-1, dtype=torch.int32)
    newid = torch.cumsum(occ.to(torch.int32), dim=-1) - 1
    lab_l = lab.long()
    own_id = torch.gather(newid, -1, lab_l)
    own_occ = torch.gather(occ, -1, lab_l)
    dense = torch.where(own_occ & (own_id < nc_pad), own_id, 0)
    dense = torch.where(real_mask, dense, nc_pad - 1)
    return dense.to(torch.int32), k


def counts_per_problem(n_real, G: int, device) -> torch.Tensor:
    """(G,) int32 on `device` from an int, a sequence or a tensor. No copy
    waits for the stream: an int is filled on the device, and a sequence is
    copied to a card from pinned memory."""
    if isinstance(n_real, (int, np.integer)):
        return torch.full((G,), int(n_real), dtype=torch.int32, device=device)
    if isinstance(n_real, torch.Tensor):
        nr = n_real.to(device, torch.int32).reshape(-1)
    else:
        nr = torch.as_tensor(n_real, dtype=torch.int32).reshape(-1)
        if torch.device(device).type == "cuda":
            nr = nr.pin_memory().to(device, non_blocking=True)
    if nr.numel() == 1 and G != 1:
        nr = nr.expand(G)
    if nr.numel() != G:
        raise ValueError(f"n_real has {nr.numel()} entries for {G} problems")
    return nr.contiguous()


def cutree_snapshots(
    merges: torch.Tensor, n_real, *, minN: int, ncand: int
) -> torch.Tensor:
    """Replay merges (G, n-1, 2) and snapshot the representative labels at
    each candidate k = minN..minN+ncand-1 -> (G, ncand, n) int32.

    Candidate row c is taken after step t with n_real - t - 1 - minN == c;
    rows no step reaches stay 0. Plain version of `cutree_snapshots_kernel`.
    """
    G, m, _ = merges.shape
    n = m + 1
    dev = merges.device
    nr = counts_per_problem(n_real, G, dev).tolist()
    labels = torch.arange(n, dtype=torch.int32, device=dev).repeat(G, 1)
    snaps = torch.zeros((G, ncand, n), dtype=torch.int32, device=dev)
    mi = merges[:, :, 0:1]
    mj = merges[:, :, 1:2]
    for t in range(n - 1):
        labels = torch.where(labels == mj[:, t], mi[:, t], labels)
        for g in range(G):
            c = nr[g] - t - 1 - minN
            if 0 <= c < ncand:
                snaps[g, c] = labels[g]
    return snaps


def cut_forest(
    snaps: torch.Tensor, n_real, real_mask: torch.Tensor, maxN, *,
    minN: int, ncand: int, nc_pad: int,
) -> CutForest:
    """Dense labels, cluster counts and the validity mask of (G, ncand, n)
    snapshots (shared by the plain and the kernel replay); real_mask (n,)
    for all problems or (G, n) one per problem; n_real and maxN an int or
    one per problem (a list or a tensor, read on the device)."""
    G = snaps.shape[0]
    rm = real_mask[:, None, :] if real_mask.dim() == 2 else real_mask
    dense, k = densify_labels(snaps, rm, nc_pad)
    nr = counts_per_problem(n_real, G, snaps.device)[:, None]
    mx = counts_per_problem(maxN, G, snaps.device)[:, None]
    ks = minN + torch.arange(ncand, device=snaps.device)[None, :]
    # nc_pad - 1 caps representable cuts (dense ids must clear the
    # reserved garbage slot)
    valid = (ks <= nr - 1) & (ks <= mx) & (ks <= nc_pad - 1)
    return CutForest(labels=dense, k=k, valid=valid)


def cutree_multi(
    merges: torch.Tensor,
    n_real: Union[int, Sequence[int], torch.Tensor],
    real_mask: torch.Tensor,
    maxN,
    *,
    minN: int,
    ncand: int,
    nc_pad: int,
) -> CutForest:
    """All cuts k = minN..minN+ncand-1 from one merge-sequence replay
    (`cutree(h, k)` per candidate, R/get_opt_hclust.R:113,132).

    merges (n_pad-1, 2) or (G, n_pad-1, 2); n_real and maxN an int or one
    per problem.
    """
    squeeze = merges.dim() == 2
    mg = merges[None] if squeeze else merges
    snaps = cutree_snapshots(mg, n_real, minN=minN, ncand=ncand)
    out = cut_forest(
        snaps, n_real, real_mask, maxN, minN=minN, ncand=ncand, nc_pad=nc_pad
    )
    return CutForest(*(x[0] for x in out)) if squeeze else out


def real_heights_tail(heights: torch.Tensor, n_real, tail: int = 10):
    """Last `tail` real merge heights, ascending — the reference's
    `tail(h$height, n=10)` (R/get_opt_hclust.R:199).

    heights (..., m); n_real an int or a tensor of the leading shape (one
    per problem, read on the device). Real merges occupy [0, n_real-1) of
    each row; when fewer than `tail` exist, the trailing invalid slots
    repeat the last valid height so adjacent diffs there are 0. Returns
    (window (..., tail), valid (..., tail)).
    """
    m = heights.shape[-1]
    if m < tail:
        heights = torch.cat([heights, heights.new_zeros(*heights.shape[:-1], tail - m)], dim=-1)
        m = tail
    if not isinstance(n_real, torch.Tensor):
        n_real = torch.full((), n_real, device=heights.device)
    nr = n_real[..., None]
    start = torch.clamp(nr - 1 - tail, 0, max(m - tail, 0))
    shape = (*heights.shape[:-1], tail)
    merge_idx = (start + torch.arange(tail, device=heights.device)).expand(shape)
    window = torch.gather(heights, -1, merge_idx)
    valid = merge_idx < nr - 1
    nvalid = valid.sum(dim=-1, keepdim=True)
    last_valid = torch.gather(window, -1, torch.clamp_min(nvalid - 1, 0))
    return torch.where(valid, window, last_valid), valid
