"""The SBLK block file format, in pure Python and numpy.

The port's copy of the Python half of `sharp_tpu/io/native.py`; files are
byte-compatible with the JAX package's codec both ways. An SBLK file holds
one cells-by-genes CSR block:

    8 bytes   magic "SBLK1\\0\\0\\0"
    2 x u32   value dtype code (0 float32, 1 uint16), reserved
    3 x u64   n (cells), g (genes), nnz
    (n+1) i64 indptr, nnz i32 column indices, nnz values

The JAX package also builds a multithreaded C++ densify with g++
(`sharp_tpu/native/blockio.cpp`); the port reads the payload memory-mapped
and densifies on the card (`io/sparse.py`), so it does not need one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

MAGIC = b"SBLK1\0\0\0"


def write_sblk(path: str, X, dtype_code: Optional[int] = None) -> None:
    """Write a cells-by-genes matrix (dense ndarray or scipy sparse) as SBLK.

    dtype_code 0 stores float32 values, 1 uint16 (lossless only for integer
    counts below 65536); None picks uint16 when the values are such counts.
    """
    import scipy.sparse as sp

    csr = X.tocsr() if sp.issparse(X) else sp.csr_matrix(np.asarray(X))
    csr.sum_duplicates()
    data = csr.data
    if dtype_code is None:
        ints = np.all(data == np.round(data)) and data.size and data.max() < 65536 and data.min() >= 0
        dtype_code = 1 if ints else 0
    n, g = csr.shape
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        np.asarray([dtype_code, 0], np.uint32).tofile(fh)
        np.asarray([n, g, csr.nnz], np.uint64).tofile(fh)
        csr.indptr.astype(np.int64).tofile(fh)
        csr.indices.astype(np.int32).tofile(fh)
        if dtype_code == 1:
            data.astype(np.uint16).tofile(fh)
        else:
            data.astype(np.float32).tofile(fh)


def _py_parse(path: str):
    """Parse an SBLK file into (n, g, nnz, dt, indptr, indices, vals).

    The payload arrays are read-only memory-mapped views of the file, not
    copies: pages fault in when the per-group slices are read.
    """
    with open(path, "rb") as fh:
        if fh.read(8) != MAGIC:
            raise IOError(f"{path}: not an SBLK file")
        dt, _ = np.fromfile(fh, np.uint32, 2)
        n, g, nnz = np.fromfile(fh, np.uint64, 3)
        off = fh.tell()
    n, g, nnz, dt = int(n), int(g), int(nnz), int(dt)
    indptr = np.memmap(path, np.int64, mode="r", offset=off, shape=(n + 1,))
    off += (n + 1) * 8
    indices = np.memmap(path, np.int32, mode="r", offset=off, shape=(nnz,))
    off += nnz * 4
    vals = np.memmap(path, np.uint16 if dt == 1 else np.float32, mode="r", offset=off, shape=(nnz,))
    return n, g, nnz, dt, indptr, indices, vals


def read_header(path: str):
    """(n, g, nnz, dtype code) of an SBLK file."""
    n, g, nnz, dt, *_ = _py_parse(path)
    return n, g, nnz, dt


def densify(path: str) -> np.ndarray:
    """Load an SBLK block as a dense (cells, genes) float32 array."""
    import scipy.sparse as sp

    n, g, _, _, indptr, indices, vals = _py_parse(path)
    csr = sp.csr_matrix((vals.astype(np.float32), indices, indptr), shape=(n, g))
    return np.asarray(csr.todense(), np.float32)
