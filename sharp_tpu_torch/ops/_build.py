"""Build and load the hand-written CUDA kernels of `sharp_tpu_torch/csrc/`.

Each `.cu` source has a plain C interface and becomes its own shared
library, compiled by `nvcc` for Hopper (`sm_90a`) at first use into
`build/kernels/` at the root of the checkout, and loaded with `ctypes`.
The libraries are keyed on a hash of their source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source is rebuilt and a built
one is reused. All sources compile in
parallel, one `nvcc` each. The first call builds and loads under a lock, so
threads that arrive at once (the shards of `parallel/sharded.py`) wait for
one build.

Flags: `--fmad=false` keeps the float arithmetic unfused (the Ward kernel
also spells its update with round-to-nearest intrinsics), and there is no
`--use_fast_math`: the Lance-Williams division and the sweep's silhouette
divisions must be IEEE, and the RP operand's `log2f` must be torch's.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("ward_serial.cu", "cutree.cu", "rnn_tail.cu", "rnn_round.cu", "rp_operand.cu", "sweep.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int
_INT64 = ctypes.c_longlong
# C signatures of the exported functions, per source
_SIGNATURES = {
    "ward_serial.cu": {
        "sharp_ward_serial_launch": (
            _INT, [_VOID_P] * 5 + [_INT, _INT, _INT, _INT, _VOID_P]
        ),
    },
    "cutree.cu": {
        "sharp_cutree_launch": (
            _INT, [_VOID_P] * 5 + [_INT] * 4 + [_VOID_P]
        ),
    },
    "rnn_tail.cu": {
        "sharp_rnn_tail_launch": (
            _INT, [_VOID_P] * 10 + [_INT, _INT, _INT, _INT, _VOID_P]
        ),
    },
    "rnn_round.cu": {
        "sharp_rnn_round_launch": (
            _INT, [_VOID_P] * 16 + [_INT] * 6 + [_VOID_P]
        ),
    },
    "rp_operand.cu": {
        "sharp_rp_operand_launch": (
            _INT, [_VOID_P, _VOID_P, _INT64] + [_INT] * 4 + [_VOID_P]
        ),
    },
    "sweep.cu": {
        "sharp_sweep_launch": (
            _INT, [_VOID_P] * 16 + [_INT] * 9 + [_VOID_P]
        ),
    },
}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
        "the CUDA kernels of sharp_tpu_torch cannot be built"
    )


def _lib_path(src: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(src).stem}_{h.hexdigest()[:16]}.so"


class BuildReport:
    """What `load_kernels` did: seconds spent and the compiler's output."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self.built: list = []
        self.log: Dict[str, str] = {}


@functools.lru_cache(maxsize=None)
def _load() -> Tuple[Dict[str, ctypes.CDLL], BuildReport]:
    report = BuildReport()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {src: _lib_path(src) for src in SOURCES if not _lib_path(src).exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for src, out in todo.items():
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs[src] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out,
            )
        failed = []
        for src, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            report.log[src] = log
            if proc.returncode != 0:
                failed.append(f"{src} (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            report.built.append(src)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    libs = {}
    for src in SOURCES:
        lib = ctypes.CDLL(str(_lib_path(src)))
        for name, (restype, argtypes) in _SIGNATURES[src].items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        libs[src] = lib
    report.seconds = time.perf_counter() - t0
    return libs, report


_LOCK = threading.Lock()


def load_kernels() -> Dict[str, ctypes.CDLL]:
    """The loaded kernel libraries by source name, built on first use."""
    with _LOCK:
        return _load()[0]


def build_report() -> BuildReport:
    """Build the kernels if needed and say what that took."""
    with _LOCK:
        return _load()[1]
