"""Minimal reader for R serialization files (.RData / .rds), XDR format v2/v3.

Copied from ``infercnvpy_tpu.io._rdata``.

Standalone replacement for the reference's ``pyreadr``/librdata dependency
(reference: io/_scevan.py:88-92).  Supports the object types that R analysis
results actually contain: atomic vectors (logical/int/real/string), pairlists,
generic lists, symbols, attributes (names/dim/dimnames/class/row.names), and
reference objects.  Matrices with dimnames and data.frames are converted to
pandas DataFrames.
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
from pathlib import Path

import numpy as np
import pandas as pd

__all__ = ["read_rdata", "read_rds"]

# SEXP type codes (R internals)
NILSXP = 0
SYMSXP = 1
LISTSXP = 2
CHARSXP = 9
LGLSXP = 10
INTSXP = 13
REALSXP = 14
CPLXSXP = 15
STRSXP = 16
VECSXP = 19
RAWSXP = 24
S4SXP = 25
ALTREP_SXP = 238
ATTRLISTSXP = 240
ATTRLANGSXP = 241
BASEENV_SXP = 242
EMPTYENV_SXP = 243
GENERICREFSXP = 245
MISSINGARG_SXP = 251
GLOBALENV_SXP = 253
NILVALUE_SXP = 254
REFSXP = 255

R_NA_INT = -2147483648


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.refs: list = []

    def read(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.read(1)[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.read(4))[0]

    def f64(self) -> float:
        return struct.unpack(">d", self.read(8))[0]

    def i32_array(self, n: int) -> np.ndarray:
        return np.frombuffer(self.read(4 * n), dtype=">i4").astype(np.int64)

    def f64_array(self, n: int) -> np.ndarray:
        return np.frombuffer(self.read(8 * n), dtype=">f8").astype(np.float64)


class RObject:
    """Parsed R object: value + attributes."""

    __slots__ = ("value", "attrs", "rtype")

    def __init__(self, value, attrs=None, rtype=None):
        self.value = value
        self.attrs = attrs or {}
        self.rtype = rtype


def _decompress(raw: bytes) -> bytes:
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    if raw[:3] == b"BZh":
        return bz2.decompress(raw)
    if raw[:6] == b"\xfd7zXZ\x00":
        return lzma.decompress(raw)
    return raw


def _parse_header(r: _Reader):
    magic = r.read(5)
    if magic in (b"RDX2\n", b"RDX3\n"):
        fmt = r.read(2)
    elif magic[:2] in (b"X\n", b"A\n", b"B\n"):
        # bare .rds has no RDX prefix; the format marker starts at offset 0
        r.pos = 0
        fmt = r.read(2)
    else:
        raise ValueError(f"Not an XDR RData/rds stream (magic={magic!r})")
    if fmt != b"X\n":
        raise ValueError(f"Only XDR ('X\\n') serialization is supported, got {fmt!r}")
    version = r.i32()
    r.i32()  # writer R version
    r.i32()  # minimal reader R version
    if version >= 3:
        enc_len = r.i32()
        r.read(enc_len)  # native encoding name
    return version


def _unpack_flags(flags: int):
    ptype = flags & 0xFF
    has_attr = bool(flags & 0x200)
    has_tag = bool(flags & 0x400)
    return ptype, has_attr, has_tag


def _read_string_vec(r: _Reader, n: int) -> np.ndarray:
    out = np.empty(n, dtype=object)
    for i in range(n):
        flags = r.i32()
        ptype = flags & 0xFF
        if ptype == NILVALUE_SXP:
            out[i] = None
            continue
        if ptype != CHARSXP:
            raise ValueError(f"Expected CHARSXP in STRSXP, got type {ptype}")
        ln = r.i32()
        out[i] = None if ln == -1 else r.read(ln).decode("utf-8", errors="replace")
    return out


def _read_object(r: _Reader) -> RObject:
    flags = r.i32()
    ptype, has_attr, has_tag = _unpack_flags(flags)

    if ptype == NILVALUE_SXP or ptype == NILSXP:
        return RObject(None, rtype=NILSXP)
    if ptype == REFSXP:
        idx = flags >> 8
        if idx == 0:
            idx = r.i32()
        return r.refs[idx - 1]
    if ptype == SYMSXP:
        char = _read_object(r)
        obj = RObject(char.value, rtype=SYMSXP)
        r.refs.append(obj)
        return obj
    if ptype == CHARSXP:
        ln = r.i32()
        return RObject(None if ln == -1 else r.read(ln).decode("utf-8", errors="replace"), rtype=CHARSXP)
    if ptype in (LISTSXP, ATTRLISTSXP):
        # tagged pairlist: read (attr), tag, car, cdr
        attrs = _read_object(r).value if has_attr else None
        tag = _read_object(r) if has_tag else None
        car = _read_object(r)
        cdr = _read_object(r)
        pairs = [(tag.value if tag else None, car)]
        if isinstance(cdr.value, list) and cdr.rtype == LISTSXP:
            pairs.extend(cdr.value)
        elif cdr.value is None and cdr.rtype in (NILSXP, NILVALUE_SXP):
            pass
        else:
            pairs.append((None, cdr))
        obj = RObject(pairs, rtype=LISTSXP)
        if attrs:
            obj.attrs = dict(attrs if isinstance(attrs, dict) else {})
        return obj
    if ptype in (GLOBALENV_SXP, BASEENV_SXP, EMPTYENV_SXP, MISSINGARG_SXP):
        return RObject(None, rtype=ptype)

    if ptype == LGLSXP:
        n = r.i32()
        raw = r.i32_array(n)
        value = np.where(raw == R_NA_INT, np.nan, raw.astype(float)).astype(object)
        value = np.asarray([bool(x) if not (isinstance(x, float) and np.isnan(x)) else None for x in value], dtype=object)
    elif ptype == INTSXP:
        n = r.i32()
        value = r.i32_array(n)
    elif ptype == REALSXP:
        n = r.i32()
        value = r.f64_array(n)
    elif ptype == CPLXSXP:
        n = r.i32()
        re_im = r.f64_array(2 * n)
        value = re_im[0::2] + 1j * re_im[1::2]
    elif ptype == STRSXP:
        n = r.i32()
        value = _read_string_vec(r, n)
    elif ptype == VECSXP:
        n = r.i32()
        value = [_read_object(r) for _ in range(n)]
    elif ptype == RAWSXP:
        n = r.i32()
        value = np.frombuffer(r.read(n), dtype=np.uint8)
    elif ptype == ALTREP_SXP:
        info = _read_object(r)
        state = _read_object(r)
        _read_object(r)  # attributes placeholder
        value = _decode_altrep(info, state)
    else:
        raise ValueError(f"Unsupported R object type {ptype} at offset {r.pos}")

    obj = RObject(value, rtype=ptype)
    if has_attr:
        attr_obj = _read_object(r)
        if attr_obj.rtype == LISTSXP and isinstance(attr_obj.value, list):
            obj.attrs = {k: v for k, v in attr_obj.value if k is not None}
    return obj


def _decode_altrep(info: RObject, state: RObject):
    """Decode the common ALTREP payloads (compact int sequences, deferred strings)."""
    name = None
    if info.rtype == LISTSXP and info.value:
        first = info.value[0][1]
        name = first.value if isinstance(first.value, str) else None
    if name == "compact_intseq":
        n, start, step = state.value[:3] if isinstance(state.value, np.ndarray) else (None, None, None)
        return (start + step * np.arange(int(n))).astype(np.int64)
    if state.rtype in (INTSXP, REALSXP, STRSXP):
        return state.value
    if state.rtype == LISTSXP and state.value:
        return state.value[0][1].value
    raise ValueError(f"Unsupported ALTREP class {name!r}")


def _r_to_py(obj: RObject):
    """Convert a parsed RObject into numpy/pandas types."""
    if obj is None or obj.value is None and not obj.attrs:
        return None
    attrs = {k: v for k, v in obj.attrs.items()}
    get = lambda k: attrs[k].value if k in attrs else None  # noqa: E731

    cls = get("class")
    names = get("names")
    dim = get("dim")

    if obj.rtype == VECSXP:
        items = [_r_to_py(x) for x in obj.value]
        if cls is not None and "data.frame" in list(np.asarray(cls)):
            cols = list(np.asarray(names)) if names is not None else [f"V{i}" for i in range(len(items))]
            df = pd.DataFrame(dict(zip(cols, items)))
            rn = attrs.get("row.names")
            if rn is not None and rn.rtype != NILSXP:
                rnv = rn.value
                # R writes compact row.names as [NA, -n]
                if isinstance(rnv, np.ndarray) and len(rnv) == 2 and rnv[0] == R_NA_INT:
                    pass
                elif rnv is not None and len(rnv) == len(df):
                    df.index = pd.Index(np.asarray(rnv))
            return df
        if names is not None:
            return dict(zip(np.asarray(names), items))
        return items

    value = obj.value
    if isinstance(value, np.ndarray):
        if obj.rtype == INTSXP:
            levels = get("levels")
            if levels is not None:  # factor
                codes = np.where(value == R_NA_INT, -1, value - 1).astype(np.int64)
                return pd.Categorical.from_codes(codes, categories=list(np.asarray(levels)))
            value = np.where(value == R_NA_INT, np.iinfo(np.int64).min, value)
        if dim is not None:
            shape = tuple(int(x) for x in np.asarray(dim))
            mat = value.reshape(shape, order="F")
            dimnames = attrs.get("dimnames")
            if dimnames is not None and dimnames.rtype == VECSXP and len(dimnames.value) == 2:
                rn = dimnames.value[0].value
                cn = dimnames.value[1].value
                return pd.DataFrame(
                    mat,
                    index=pd.Index(np.asarray(rn)) if rn is not None else None,
                    columns=pd.Index(np.asarray(cn)) if cn is not None else None,
                )
            return mat
        if names is not None:
            return pd.Series(value, index=pd.Index(np.asarray(names)))
        return value
    if obj.rtype == LISTSXP:
        return {k: _r_to_py(v) for k, v in obj.value if k is not None}
    return value


def read_rdata(path) -> dict:
    """Read an .RData workspace file; returns {object_name: converted value}."""
    raw = _decompress(Path(path).read_bytes())
    r = _Reader(raw)
    _parse_header(r)
    top = _read_object(r)
    if top.rtype != LISTSXP:
        raise ValueError(".RData top-level object is not a pairlist of bindings")
    return {name: _r_to_py(val) for name, val in top.value if name is not None}


def read_rds(path):
    """Read a single-object .rds file."""
    raw = _decompress(Path(path).read_bytes())
    r = _Reader(raw)
    _parse_header(r)
    return _r_to_py(_read_object(r))
