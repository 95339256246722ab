"""Sparse block feed: ship CSR triplets to the card, densify there.

Counterpart of `sharp_tpu/io/sparse.py`. The reference streams dense RDS
blocks and densifies on the host (R/SHARP_unlimited3.R:103-131). A 50,000 x
27,998 block is 5.6 GB dense but under 1 GB as CSR at single-cell
densities, so the streaming path ships each fold group as per-row COUNTS,
column ids (uint16 when the genes fit, int32 otherwise) and values, about
6 bytes per nonzero; row ids are derived on the card from the counts and
the values are scattered into the padded dense folds, with log2(1 + x)
applied to the values first (zeros stay zeros).

The scatter places the same float32 values a host densify would, so a
sparse-fed run and a dense-fed run give identical labels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sharp_tpu_torch.ops import rp

WIRE_DTYPES = ("float32", "bfloat16")


class SparseBlock(NamedTuple):
    """A cells-by-genes CSR block on the host."""

    n: int
    g: int
    indptr: np.ndarray   # (n + 1,) int64
    indices: np.ndarray  # (nnz,) int32, sorted within each row
    data: np.ndarray     # (nnz,) float32

    @property
    def shape(self):
        return (self.n, self.g)

    def __len__(self):
        return self.n

    @classmethod
    def from_scipy(cls, X) -> "SparseBlock":
        """The block of a scipy sparse matrix, canonicalised in place (as
        scipy does); its ids and values are shared, not copied, where they
        are int32 and float32 already, as `from_sblk` shares its mapping."""
        csr = X.tocsr()
        csr.sum_duplicates()
        csr.sort_indices()
        return cls(
            n=csr.shape[0], g=csr.shape[1],
            indptr=csr.indptr.astype(np.int64),
            indices=csr.indices.astype(np.int32, copy=False),
            data=csr.data.astype(np.float32, copy=False),
        )

    @classmethod
    def from_sblk(cls, path: str) -> "SparseBlock":
        """The block of an SBLK file, its payload memory-mapped (no copy for
        float32 values; uint16 values convert)."""
        from sharp_tpu_torch.io.native import _py_parse

        n, g, nnz, dt, indptr, indices, vals = _py_parse(path)
        # fault the mapped payload in now, one touch per 4 KB page: this
        # runs on the prefetch thread, beside the previous block's work
        for a in (indices, vals):
            if a.size:
                a.reshape(-1)[:: 4096 // a.itemsize].max()
        return cls(
            n=n, g=g, indptr=indptr.astype(np.int64, copy=False),
            indices=indices.astype(np.int32, copy=False),
            data=vals.astype(np.float32, copy=False),
        )

    def densify(self) -> np.ndarray:
        import scipy.sparse as sp

        return np.asarray(
            sp.csr_matrix((self.data, self.indices, self.indptr), shape=self.shape).todense(),
            np.float32,
        )


def nnz_pad(nnz: int, step: int = 1 << 19) -> int:
    """Pad an nnz count to a coarse bucket."""
    return max(step, ((nnz + step - 1) // step) * step)


def wire_dtypes(genes: int, wire_dtype: str = "float32") -> Tuple[torch.dtype, torch.dtype]:
    """(cols, vals) dtypes of the wire: int16 holding uint16 ids (int32 past
    65536 genes), and float32 or bfloat16."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire_dtype {wire_dtype!r} (one of {WIRE_DTYPES})")
    cdt = torch.int16 if genes <= np.iinfo(np.uint16).max + 1 else torch.int32
    return cdt, torch.bfloat16 if wire_dtype == "bfloat16" else torch.float32


def wire_buffers(
    G: int, block_pad: int, budget: int, genes: int, wire_dtype: str = "float32",
    pin: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Host tensors (counts, cols, vals) for the wire of G folds:
    counts (G, block_pad) int32, cols (G, budget) and vals (G, budget) of
    `wire_dtypes`. `pin` allocates page-locked memory (for copies to a
    card); cols and vals are left unset, only the first nnz entries of a
    fold are ever read."""
    cdt, vdt = wire_dtypes(genes, wire_dtype)
    return (
        torch.zeros((G, block_pad), dtype=torch.int32, pin_memory=pin),
        torch.empty((G, budget), dtype=cdt, pin_memory=pin),
        torch.empty((G, budget), dtype=vdt, pin_memory=pin),
    )


def fold_triplets(
    sb: SparseBlock,
    starts: Sequence[int],
    sizes: Sequence[int],
    block_pad: int,
    budget: int,
    wire_dtype: str = "float32",
    out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
):
    """The wire (counts, cols, vals) of a group of folds of one block, as
    host tensors (`wire_buffers`): fold gi holds the rows starts[gi] ..
    starts[gi] + sizes[gi] of `sb`.

    counts are per-row nonzero counts (zero on pad rows): row ids are
    derived on the card, so the O(nnz) row vector never crosses the link.
    vals are exact float32, or rounded to bfloat16 (to nearest even) with
    `wire_dtype="bfloat16"`, 4 bytes per nonzero instead of 6: a lossy
    opt-in; the default keeps sparse-fed and dense-fed runs identical.
    Entries past a fold's nnz are dropped on the card. `out` fills the
    first G rows of given buffers (zeroing their counts) instead of new
    zeroed ones.
    """
    G = len(starts)
    if out is None:
        counts, cols, vals = wire_buffers(G, block_pad, budget, sb.g, wire_dtype)
        cols.zero_()
        vals.zero_()
    else:
        counts, cols, vals = (t[:G] for t in out)
        counts.zero_()
    if tuple(cols.shape) != (G, budget) or counts.shape[1] != block_pad:
        raise ValueError(
            f"wire buffers {tuple(counts.shape)}/{tuple(cols.shape)} do not hold {G} folds "
            f"of {block_pad} rows and {budget} nonzeros"
        )
    counts_np = counts.numpy()
    cols_np = cols.numpy()
    if cols.dtype == torch.int16:
        cols_np = cols_np.view(np.uint16)
    vals_np = vals.numpy() if vals.dtype == torch.float32 else None
    for gi, (r0, sz) in enumerate(zip(starts, sizes)):
        p0 = int(sb.indptr[r0])
        p1 = int(sb.indptr[r0 + sz])
        nnz = p1 - p0
        if nnz > budget:
            raise ValueError(f"fold nnz {nnz} exceeds budget {budget}; raise nnz_pad step")
        counts_np[gi, :sz] = np.diff(sb.indptr[r0 : r0 + sz + 1])
        cols_np[gi, :nnz] = sb.indices[p0:p1]
        if vals_np is not None:
            vals_np[gi, :nnz] = sb.data[p0:p1]
        else:
            vals[gi, :nnz] = torch.from_numpy(np.array(sb.data[p0:p1], np.float32))
    return counts, cols, vals


def densify_folds(
    counts: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, *,
    block_pad: int, genes: int, log2p1: bool = False,
) -> torch.Tensor:
    """Scatter a group's wire (`fold_triplets`, on the device) into dense
    (G, block_pad, genes) float32 folds, on the wire's device.

    Row ids are derived from the per-row counts: the row of entry i is the
    number of row-end markers at positions <= i (a marker at each row's
    end offset; empty rows stack their markers), one scatter-add of
    block_pad markers and one O(nnz) prefix sum, never a binary search.
    Entries past the fold's nnz derive row == block_pad and are dropped.
    `log2p1` applies log2(1 + x) to the values before the scatter, which
    equals densify-then-log2 entry by entry.
    """
    G, budget = cols.shape
    dev = cols.device
    cum = counts.long().cumsum(dim=1)
    marker = torch.zeros((G, budget + 1), dtype=torch.int64, device=dev)
    marker.scatter_add_(1, cum.clamp(max=budget), torch.ones_like(cum))
    r = marker[:, :budget].cumsum(dim=1)
    c = cols.long()
    if cols.dtype == torch.int16:
        c = c & 0xFFFF
    v = vals.float()
    if log2p1:
        v = rp.log2p1(v)
    size = G * block_pad * genes
    g = torch.arange(G, device=dev)[:, None]
    # dropped entries all go to one extra slot past the folds
    idx = torch.where(r < block_pad, (g * block_pad + r) * genes + c, size)
    flat = torch.zeros(size + 1, dtype=torch.float32, device=dev)
    flat.scatter_(0, idx.reshape(-1), v.reshape(-1))
    return flat[:size].view(G, block_pad, genes)
