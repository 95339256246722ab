"""Minimal pure-python reader for R serialization (.rds / .RData).

The port's copy of `sharp_tpu/io/rdata.py` (numpy only).

Reads the subset of R's XDR serialization format needed to consume the
reference package's data artifacts (e.g. the bundled ground-truth factor
`data/label.RData`, and user-provided expression matrices saved from R):
atomic vectors (logical/integer/real/string), factors, matrices (dim/
dimnames attributes), pairlists and generic lists, with gzip/bzip2/xz
compression. Not a general R reader — unsupported types raise.

Format reference: R Internals, "Serialization Formats" (public spec).
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
from typing import Any, BinaryIO, Dict, Optional

import numpy as np

# SEXP type codes
_NILSXP = 0
_SYMSXP = 1
_LISTSXP = 2
_CHARSXP = 9
_LGLSXP = 10
_INTSXP = 13
_REALSXP = 14
_CPLXSXP = 15
_STRSXP = 16
_VECSXP = 19
_RAWSXP = 24
_REFSXP = 255
_NILVALUE = 254
_GLOBALENV = 253
_UNBOUNDVALUE = 252
_MISSINGARG = 251
_BASEENV = 250
_NAMESPACESXP = 249
_ALTREP = 238

_NA_INT = -2147483648


class RFactor:
    """An R factor: integer codes (1-based) + levels."""

    def __init__(self, codes: np.ndarray, levels: list):
        self.codes = codes
        self.levels = levels

    def as_strings(self) -> np.ndarray:
        out = np.empty(len(self.codes), object)
        for i, c in enumerate(self.codes):
            out[i] = None if c == _NA_INT else self.levels[c - 1]
        return out

    def __len__(self):
        return len(self.codes)

    def __repr__(self):
        return f"RFactor(n={len(self.codes)}, levels={self.levels})"


class _Parser:
    def __init__(self, fh: BinaryIO):
        self.fh = fh
        self.refs = []

    # --- low-level XDR reads ---
    def _read(self, n: int) -> bytes:
        b = self.fh.read(n)
        if len(b) != n:
            raise EOFError("truncated R serialization stream")
        return b

    def u32(self) -> int:
        return struct.unpack(">I", self._read(4))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._read(4))[0]

    def f64(self, n: int) -> np.ndarray:
        return np.frombuffer(self._read(8 * n), ">f8").astype(np.float64)

    def i32v(self, n: int) -> np.ndarray:
        return np.frombuffer(self._read(4 * n), ">i4").astype(np.int32)

    # --- header ---
    def header(self):
        fmt = self._read(2)
        if fmt != b"X\n":
            raise ValueError(f"only XDR format supported, got {fmt!r}")
        version = self.u32()
        self.u32()  # writer version
        self.u32()  # min reader version
        if version >= 3:
            enc_len = self.u32()
            self._read(enc_len)  # native encoding name
        return version

    # --- object parsing ---
    def obj(self) -> Any:
        flags = self.u32()
        typ = flags & 0xFF
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)

        if typ == _NILVALUE or typ == _NILSXP:
            return None
        if typ == _REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.u32()
            return self.refs[idx - 1]
        if typ == _SYMSXP:
            name = self.obj()  # CHARSXP
            self.refs.append(name)
            return name
        if typ == _CHARSXP:
            n = self.i32()
            return None if n < 0 else self._read(n).decode("utf-8", "replace")
        if typ == _LISTSXP:
            attr = self.obj() if has_attr else None
            tag = self.obj() if has_tag else None
            car = self.obj()
            cdr = self.obj()
            pairs = [(tag, car)]
            while isinstance(cdr, _Pairlist):
                pairs.extend(cdr.pairs)
                cdr = None
            del attr
            return _Pairlist(pairs)
        if typ in (_LGLSXP, _INTSXP):
            n = self.u32()
            data = self.i32v(n)
            attrs = self._attrs(has_attr)
            return self._vector(data, attrs, integer=True)
        if typ == _REALSXP:
            n = self.u32()
            data = self.f64(n)
            attrs = self._attrs(has_attr)
            return self._vector(data, attrs, integer=False)
        if typ == _STRSXP:
            n = self.u32()
            out = np.empty(n, object)
            for i in range(n):
                out[i] = self.obj()
            attrs = self._attrs(has_attr)
            return self._vector(out, attrs, integer=False)
        if typ == _VECSXP:
            n = self.u32()
            items = [self.obj() for _ in range(n)]
            attrs = self._attrs(has_attr)
            names = _attr_get(attrs, "names")
            if names is not None:
                return dict(zip([str(s) for s in names], items))
            return items
        if typ == _RAWSXP:
            n = self.u32()
            return np.frombuffer(self._read(n), np.uint8)
        if typ == _ALTREP:
            # ALTREP payload: info pairlist, state, attributes. The common
            # compact_intseq / wrapped arrays expand below.
            info = self.obj()
            state = self.obj()
            self.obj()  # attr
            return _expand_altrep(info, state)
        raise ValueError(f"unsupported R SEXP type {typ}")

    def _attrs(self, has_attr: bool):
        return self.obj() if has_attr else None

    def _vector(self, data, attrs, integer: bool):
        levels = _attr_get(attrs, "levels")
        klass = _attr_get(attrs, "class")
        dim = _attr_get(attrs, "dim")
        if levels is not None and klass is not None and "factor" in list(klass):
            return RFactor(np.asarray(data, np.int32), [str(s) for s in levels])
        arr = np.asarray(data)
        if dim is not None:
            # R is column-major
            arr = arr.reshape(tuple(int(d) for d in dim), order="F")
            dimnames = _attr_get(attrs, "dimnames")
            if dimnames is not None:
                return RMatrix(arr, dimnames)
        return arr


class _Pairlist:
    def __init__(self, pairs):
        self.pairs = pairs

    def as_dict(self) -> Dict[str, Any]:
        return {str(t): v for t, v in self.pairs if t is not None}


class RMatrix:
    """An R matrix with dimnames."""

    def __init__(self, values: np.ndarray, dimnames):
        self.values = values
        self.rownames = (
            np.asarray(dimnames[0], object) if dimnames and dimnames[0] is not None else None
        )
        self.colnames = (
            np.asarray(dimnames[1], object)
            if dimnames and len(dimnames) > 1 and dimnames[1] is not None
            else None
        )

    @property
    def shape(self):
        return self.values.shape


def _attr_get(attrs, name: str):
    if attrs is None or not isinstance(attrs, _Pairlist):
        return None
    for tag, val in attrs.pairs:
        if tag is not None and str(tag) == name:
            return val
    return None


def _expand_altrep(info, state):
    # info is a pairlist-ish (class symbol, package, type); the common case
    # in data files is compact_intseq with state [n, start, step]
    try:
        name = str(info.pairs[0][1]) if isinstance(info, _Pairlist) else str(info)
    except Exception:
        name = ""
    if "compact_intseq" in name and state is not None:
        n, start, step = [float(x) for x in np.ravel(state)[:3]]
        return (start + step * np.arange(int(n))).astype(np.int32)
    if isinstance(state, (np.ndarray, list)):
        return np.asarray(state[0] if isinstance(state, list) else state)
    raise ValueError(f"unsupported ALTREP {name!r}")


def _open_maybe_compressed(path: str) -> BinaryIO:
    with open(path, "rb") as fh:
        magic = fh.read(6)
    if magic[:2] == b"\x1f\x8b":
        return gzip.open(path, "rb")
    if magic[:3] == b"BZh":
        return bz2.open(path, "rb")
    if magic[:6] == b"\xfd7zXZ\x00":
        return lzma.open(path, "rb")
    return open(path, "rb")


def read_rds(path: str) -> Any:
    """Read a single R object saved with saveRDS()."""
    with _open_maybe_compressed(path) as fh:
        p = _Parser(fh)
        p.header()
        return p.obj()


def read_rdata(path: str) -> Dict[str, Any]:
    """Read an .RData workspace saved with save(); returns {name: object}."""
    with _open_maybe_compressed(path) as fh:
        magic = fh.read(5)
        if magic not in (b"RDX2\n", b"RDX3\n"):
            raise ValueError(f"{path}: not an RData file (magic {magic!r})")
        p = _Parser(fh)
        p.header()
        top = p.obj()
    if isinstance(top, _Pairlist):
        return top.as_dict()
    raise ValueError("unexpected RData top-level object")
