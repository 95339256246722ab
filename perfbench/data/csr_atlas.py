"""The CSR atlas's blocks, made on the card from the run's seed and held as
scipy CSR matrices in host memory, as a lab holds a sparse 10x atlas.

Each cell has `nnz` nonzero genes, in canonical CSR (column ids sorted and
unique). Three quarters of them are the top-expressed genes of its planted
type, as `sharp_tpu_torch/io/benchdata.py`'s recipe has it, so same-type
cells share genes; the rest are a tail drawn without replacement from the
other genes. A value is its type's mean for the gene (a log-normal base,
35% of the genes differentially expressed at +/-6 log2 fold change, as
`atlas.AtlasData` draws them) times exp(0.3 N) noise, each cell scaled to
1e6. Types are drawn uniformly per cell. The draws run on the device with
`torch.Generator`s, one for the type means and one per block, so a block
can be made again on its own; only the finished blocks cross to the host,
since numpy would take minutes for billions of nonzeros.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from perfbench.data.atlas import seeds


class CsrAtlas:
    """The atlas's type means and each block's cells, on `dev`."""

    def __init__(self, n_genes: int, n_types: int, nnz: int, seed: int, dev):
        if not 0 < nnz <= n_genes:
            raise ValueError(f"{nnz} nonzeros a cell do not fit {n_genes} genes")
        self.n_genes, self.n_types, self.nnz, self.dev = n_genes, n_types, nnz, dev
        means_seed, self.block_seed = seeds(seed, 2)
        g = torch.Generator(device=dev)
        g.manual_seed(means_seed)
        base = torch.exp(1.0 + torch.randn(n_genes, generator=g, device=dev))
        de = torch.rand(n_genes, generator=g, device=dev) < 0.35
        signs = torch.randint(0, 2, (n_types, n_genes), generator=g, device=dev).float() * 2.0 - 1.0
        self.type_means = base[None, :] * torch.where(de[None, :], 2.0 ** (signs * 6.0), 1.0)
        self.n_top = (nnz * 3) // 4
        self.top = torch.argsort(-self.type_means, dim=1)[:, : self.n_top]       # (n_types, n_top)

    def block(self, b: int, n: int, chunk: int = 4096) -> Tuple["object", np.ndarray]:
        """Block b of n cells -> (its scipy CSR matrix (n, genes) in host
        memory, float32 values and int32 ids, its planted types (n,))."""
        import scipy.sparse as sp

        dev, k = self.dev, self.nnz
        g = torch.Generator(device=dev)
        g.manual_seed((self.block_seed + b) % (1 << 63))
        y = torch.randint(0, self.n_types, (n,), generator=g, device=dev)
        indices = np.empty(n * k, np.int32)
        data = np.empty(n * k, np.float32)
        for c0 in range(0, n, chunk):
            m = min(chunk, n - c0)
            yc = y[c0 : c0 + m]
            top = self.top[yc]
            keys = torch.rand((m, self.n_genes), generator=g, device=dev)
            keys.scatter_(1, top, 2.0)           # a type's top genes are never its tail
            tail = torch.topk(keys, k - self.n_top, dim=1, largest=False, sorted=False).indices
            del keys
            cols = torch.cat([top, tail], dim=1).sort(dim=1).values
            vals = self.type_means[yc[:, None], cols] * torch.exp(
                0.3 * torch.randn((m, k), generator=g, device=dev))
            vals *= 1e6 / vals.sum(dim=1, keepdim=True)
            torch.from_numpy(indices[c0 * k : (c0 + m) * k]).copy_(cols.reshape(-1).to(torch.int32))
            torch.from_numpy(data[c0 * k : (c0 + m) * k]).copy_(vals.reshape(-1))
        itype = np.int32 if n * k < 2**31 else np.int64
        indptr = np.arange(n + 1, dtype=itype) * k
        csr = sp.csr_matrix((data, indices.astype(itype, copy=False), indptr), shape=(n, self.n_genes))
        return csr, y.cpu().numpy()
