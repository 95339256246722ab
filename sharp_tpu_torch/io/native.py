"""The SBLK block file format and its native codec.

The port's copy of `sharp_tpu/io/native.py`; files are byte-compatible with
the JAX package's codec both ways. An SBLK file holds one cells-by-genes
CSR block:

    8 bytes   magic "SBLK1\\0\\0\\0"
    2 x u32   value dtype code (0 float32, 1 uint16), reserved
    3 x u64   n (cells), g (genes), nnz
    (n+1) i64 indptr, nnz i32 column indices, nnz values

`densify` reads a block through the multithreaded C++ codec
(`sharp_tpu_torch/csrc/blockio.cpp`), which g++ builds at first use into
`build/native/` at the root of the checkout (or `$SHARP_TPU_NATIVE_CACHE`),
keyed on a hash of the source, and `ctypes` loads. `get_lib()` is None only
where no g++ exists; then `densify` falls back to its plain numpy version,
`_py_densify`. A build that fails with g++ present raises. The sparse feed
(`io/sparse.py`) reads the payload memory-mapped (`_py_parse`) and
densifies on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

MAGIC = b"SBLK1\0\0\0"
SRC = Path(__file__).resolve().parent.parent / "csrc" / "blockio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build_lib() -> Optional[ctypes.CDLL]:
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    src = SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    cache = Path(os.environ.get("SHARP_TPU_NATIVE_CACHE") or BUILD_DIR)
    cache.mkdir(parents=True, exist_ok=True)
    so = cache / f"blockio_{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC} (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.sblk_read_header.argtypes = [ctypes.c_char_p, u64p, u64p, u64p, ctypes.POINTER(ctypes.c_uint32)]
    lib.sblk_read_header.restype = ctypes.c_int
    lib.sblk_densify.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int]
    lib.sblk_densify.restype = ctypes.c_int
    lib.sblk_densify_rows.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, f32p, ctypes.c_int]
    lib.sblk_densify_rows.restype = ctypes.c_int
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded codec, built on first use under a lock; None without g++."""
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _build_lib()
            _TRIED = True
        return _LIB


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


def read_header(path: str):
    """(n, g, nnz, dtype code) of an SBLK file."""
    lib = get_lib()
    if lib is None:
        return _py_read_header(path)
    n, g, nnz, dt = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint32()
    rc = lib.sblk_read_header(path.encode(), n, g, nnz, dt)
    if rc != 0:
        raise IOError(f"sblk_read_header({path}) failed: rc={rc}")
    return int(n.value), int(g.value), int(nnz.value), int(dt.value)


def densify(path: str, n_threads: int = 0) -> np.ndarray:
    """Load an SBLK block as a dense (cells, genes) float32 array, on
    `n_threads` host threads (0: all cores)."""
    n, g, _, _ = read_header(path)
    lib = get_lib()
    if lib is None:
        return _py_densify(path)
    out = np.empty((n, g), np.float32)
    rc = lib.sblk_densify(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    if rc != 0:
        raise IOError(f"sblk_densify({path}) failed: rc={rc}")
    return out


# --- the plain numpy version --------------------------------------------------

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


def _py_read_header(path: str):
    n, g, nnz, dt, *_ = _py_parse(path)
    return n, g, nnz, dt


def _py_densify(path: str) -> np.ndarray:
    """`densify` in scipy: the codec's plain version."""
    import scipy.sparse as sp

    n, g, _, _, indptr, indices, vals = _py_parse(path)
    csr = sp.csr_matrix((vals.astype(np.float32), indices, indptr), shape=(n, g))
    return np.asarray(csr.todense(), np.float32)
