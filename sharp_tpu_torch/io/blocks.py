"""On-disk block store for out-of-core runs: the port's copy of
`sharp_tpu/io/blocks.py`.

The reference's RDS-file block convention (R/SHARP_unlimited3.R:59-114:
list the files of a directory, sort them by the numeric filename
component, read one at a time). Blocks are .npz (a dense "X" array, or a
scipy CSR save), .npy or SBLK (`io/native.py`); a directory of blocks plus
a shape manifest (`blocks.json`) is the unit of streaming input.
"""

from __future__ import annotations

import json
import os
import re
from typing import Iterator, List, Optional, Sequence

import numpy as np

_NUM = re.compile(r"(\d+)")


def _numeric_key(name: str):
    # the FIRST numeric component, as the reference orders its block files
    # (R/get_marker_genes_unlimited2.R:160, R/SHARP_unlimited3.R:59-62)
    parts = _NUM.findall(name)
    return (int(parts[0]) if parts else 0, name)


class BlockStore:
    """A directory of cell-block files (cells x genes each)."""

    def __init__(self, directory: str):
        self.directory = directory

    # --- reading ---------------------------------------------------------
    def files(self) -> List[str]:
        names = [
            f
            for f in os.listdir(self.directory)
            if f.endswith((".npz", ".npy", ".sblk")) and not f.startswith(".")
        ]
        # files without a numeric component all key as 0 and would
        # interleave unpredictably with numbered ones: refuse the mix
        n_numeric = sum(1 for f in names if _NUM.search(f))
        if 0 < n_numeric < len(names):
            plain = [f for f in names if not _NUM.search(f)]
            raise ValueError(
                "block directory mixes numbered and unnumbered filenames "
                f"(unnumbered: {plain[:5]}); block order would be "
                "ambiguous — use one naming convention"
            )
        names.sort(key=_numeric_key)
        return [os.path.join(self.directory, f) for f in names]

    @staticmethod
    def load(path: str) -> np.ndarray:
        if path.endswith(".sblk"):
            from sharp_tpu_torch.io.native import densify

            return densify(path)
        if path.endswith(".npy"):
            return np.load(path).astype(np.float32, copy=False)
        with np.load(path, allow_pickle=False) as z:
            if "format" in z.files:  # scipy sparse save_npz layout
                import scipy.sparse as sp

                return np.asarray(sp.load_npz(path).todense(), dtype=np.float32)
            key = "X" if "X" in z.files else z.files[0]
            return z[key].astype(np.float32, copy=False)

    def __iter__(self) -> Iterator[np.ndarray]:
        for f in self.files():
            yield self.load(f)

    def shape_info(self) -> Optional[dict]:
        meta = os.path.join(self.directory, "blocks.json")
        if os.path.exists(meta):
            with open(meta) as fh:
                return json.load(fh)
        return None

    # --- writing ---------------------------------------------------------
    def write(self, blocks: Sequence[np.ndarray], compress: bool = False, fmt: str = "npz"):
        """Write blocks as block_00000.npz, ... (fmt="npz") or SBLK files
        (fmt="sblk", dense arrays or scipy sparse), and blocks.json."""
        os.makedirs(self.directory, exist_ok=True)
        n_cells = 0
        n_genes = None
        save = np.savez_compressed if compress else np.savez
        for i, b in enumerate(blocks):
            if fmt == "sblk":
                from sharp_tpu_torch.io.native import write_sblk

                n_cells += b.shape[0]
                n_genes = b.shape[1]
                write_sblk(os.path.join(self.directory, f"block_{i:05d}.sblk"), b)
                continue
            b = np.asarray(b, np.float32)
            n_cells += b.shape[0]
            n_genes = b.shape[1]
            save(os.path.join(self.directory, f"block_{i:05d}.npz"), X=b)
        with open(os.path.join(self.directory, "blocks.json"), "w") as fh:
            json.dump({"n_cells": n_cells, "n_genes": n_genes, "n_blocks": i + 1}, fh)


def save_blocks(directory: str, blocks: Sequence[np.ndarray], **kw):
    BlockStore(directory).write(blocks, **kw)
