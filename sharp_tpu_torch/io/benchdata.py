"""The flagship dataset of the bench's API path, as SBLK files.

The port's copy of `bench.py`'s generator (`_api_dataset_dir`,
`_api_type_means`, `_api_block_y`, `_api_gen_block`): 50,000-cell blocks
of 27,998 genes with 38 planted types; each cell has `keep` nonzero genes,
three quarters of them its type's top-expressed genes and the rest a
random tail, scaled to 1e6 per cell. Type means come from numpy seed 123,
block b from seed 1000 + b, so each block is made on its own and its file
is the same whether the blocks are made at once or on demand. Files are
byte-compatible with the JAX package's, so the two packages read the same
data.
"""

from __future__ import annotations

import os
import time

import numpy as np


def dataset_dir(n_cells: int, G: int, n_types: int, keep: int) -> str:
    """The content-keyed cache directory of a dataset: under
    `SHARP_BENCH_API_DIR`, else `~/.cache/sharp_tpu_torch/benchdata`."""
    root = os.environ.get(
        "SHARP_BENCH_API_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "sharp_tpu_torch", "benchdata"),
    )
    return os.path.join(root, f"v2_{n_cells}_{G}_{n_types}_{keep}")


def type_means(G: int, n_types: int, keep: int):
    """(type means (n_types, G), each type's top-expressed genes
    (n_types, n_top), n_top). A cell's nonzero support is mostly its type's
    top genes: same-type cells share genes, as real single-cell data's
    expression-correlated sparsity does."""
    grng = np.random.default_rng(123)
    base = np.exp(1.0 + grng.standard_normal(G)).astype(np.float32)
    de = grng.uniform(size=G) < 0.35
    signs = grng.choice(np.asarray([-1.0, 1.0], np.float32), size=(n_types, G))
    tm = (base * np.where(de, 2.0 ** (signs * 6.0), 1.0)).astype(np.float32)
    n_top = (keep * 3) // 4
    top = np.argsort(-tm, axis=1)[:, :n_top].astype(np.int32)
    return tm, top, n_top


def block_y(bi: int, bn: int, n_types: int) -> np.ndarray:
    """The planted labels of block bi: the first draw of its generator, so
    they are known without reading the block."""
    return np.random.default_rng(1000 + bi).integers(0, n_types, bn)


def gen_block(path: str, bi: int, bn: int, G: int, keep: int, tm, top, n_top) -> None:
    """Write block bi (bn cells) to `path` as SBLK, atomically (a temporary
    file, then a rename)."""
    import scipy.sparse as sp

    from sharp_tpu_torch.io.native import write_sblk

    rng = np.random.default_rng(1000 + bi)
    y = rng.integers(0, tm.shape[0], bn)
    tail = rng.integers(0, G, (bn, keep - n_top), dtype=np.int32)
    cols = np.concatenate([top[y], tail], axis=1)
    cols.sort(axis=1)
    vals = tm[y[:, None], cols] * np.exp(0.3 * rng.standard_normal((bn, keep), dtype=np.float32))
    vals *= 1e6 / vals.sum(axis=1, keepdims=True)
    indptr = np.arange(bn + 1, dtype=np.int64) * keep
    csr = sp.csr_matrix((vals.ravel(), cols.ravel(), indptr), shape=(bn, G))
    write_sblk(path + ".tmp", csr, dtype_code=0)
    os.replace(path + ".tmp", path)


def _available_bytes() -> int | None:
    """The host memory that can be had without swapping (Linux's
    MemAvailable), or None where it cannot be read."""
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def make_blocks(ddir: str, blocks, G: int, n_types: int, keep: int) -> float:
    """Make the blocks the dataset directory `ddir` lacks, as
    `ddir/block_<b>.sblk` (`blocks`: the cells of each block), in a pool of
    spawned processes, one a core and a missing block, as many as the
    host's free memory holds (a block peaks at about 32 bytes a nonzero);
    returns the seconds it took."""
    import concurrent.futures
    import multiprocessing

    os.makedirs(ddir, exist_ok=True)
    missing = [bi for bi in range(len(blocks)) if not os.path.exists(os.path.join(ddir, f"block_{bi:05d}.sblk"))]
    if not missing:
        return 0.0
    t0 = time.perf_counter()
    tm, top, n_top = type_means(G, n_types, keep)
    workers = min(os.cpu_count() or 1, len(missing))
    avail = _available_bytes()
    if avail is not None:
        workers = max(1, min(workers, avail // (32 * keep * max(blocks[bi] for bi in missing))))
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [pool.submit(gen_block, os.path.join(ddir, f"block_{bi:05d}.sblk"), bi, blocks[bi], G, keep, tm, top,
                            n_top) for bi in missing]
        for job in jobs:
            job.result()
    return time.perf_counter() - t0
