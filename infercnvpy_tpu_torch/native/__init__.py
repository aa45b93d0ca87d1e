"""The host packers in C++ (``pack.cpp``), built with g++ at first use and loaded via ctypes.

Counterpart of the pack half of ``infercnvpy_tpu/native/__init__.py``, with
its own copy of the source.  The library goes into the gitignored
``infercnvpy_tpu_torch/_build/`` under a name that carries a hash of the
source and flags; the build writes a temporary file and renames it, so
concurrent processes never load a partial library.  A failed build raises
with g++'s stderr: nothing falls back to numpy.  The numpy versions in
``ops/sparse_ingest.py`` and ``ops/infercnv_kernel.py`` are the references
the tests hold these against.

Every wrapper checks dtypes, shapes and index bounds before it passes a
pointer (the C scatters are unchecked), runs on ``torch.get_num_threads()``
OpenMP threads, releases the GIL for the call (ctypes does), counts its calls
in ``.calls``, and can write into caller-owned ``out`` buffers, such as
pinned host memory, which it overwrites completely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["library", "build", "pack_csr", "pack_dense", "coo_remap", "dense_to_csr", "GXX_FLAGS"]

_SRC = Path(__file__).resolve().parent / "pack.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp")

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_SIGNATURES = {
    # indptr, indices, data, n_rows, lut, out_width, out, n_threads
    "pack_csr": (_I64, (_I64P, _I32P, _P, _I64, _I64P, _I64, _P, _I32)),
    # src, n_rows, n_cols, lut, out_width, out, n_threads
    "pack_dense": (None, (_P, _I64, _I64, _I64P, _I64, _P, _I32)),
    # indptr, indices, data, n_rows, lut, cap, row_offsets, cols, cols_is16, vals, bf16_vals, counts, n_threads
    "coo_remap": (_I64, (_I64P, _I32P, _P, _I64, _I64P, _I64, _I64P, _P, _I32, _P, _I32, _I32P, _I32)),
    # src, n_rows, n_cols, row_nnz, n_threads
    "dense_nnz_rows": (None, (_P, _I64, _I64, _I64P, _I32)),
    # src, n_rows, n_cols, indptr, indices, data, n_threads
    "dense_fill_csr": (None, (_P, _I64, _I64, _I64P, _I32P, _P, _I32)),
}
_SUFFIX = {np.dtype(np.float32): "f32", np.dtype(np.float64): "f64"}

_LIB = None


def build() -> Path:
    """Compile ``pack.cpp`` if no library for the current source exists; return its path."""
    tag = hashlib.sha256(repr(GXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libinfercnv_pack-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library() -> ctypes.CDLL:
    """The loaded packer library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for stem, (restype, args) in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{stem}_{suffix}")
                fn.restype = restype
                fn.argtypes = list(args)
        _LIB = lib
    return _LIB


def _threads() -> int:
    import torch

    return max(1, torch.get_num_threads())


def _float_array(a, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype not in _SUFFIX:
        raise TypeError(f"{what} must be float32 or float64, got {a.dtype}")
    return a


def _out_buffer(out, shape, dtype, what: str) -> np.ndarray:
    if out is None:
        return np.empty(shape, dtype=dtype)
    if out.shape != tuple(shape) or out.dtype != np.dtype(dtype) or not out.flags.c_contiguous:
        raise ValueError(f"{what} must be a C-contiguous {np.dtype(dtype)} array of shape {tuple(shape)}, "
                         f"got {out.dtype} {out.shape}")
    return out


def _csr_arrays(indptr, indices, lut):
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    lut = np.ascontiguousarray(lut, dtype=np.int64)
    if len(indptr) == 0 or indptr[0] < 0 or indptr[-1] > len(indices) or np.any(np.diff(indptr) < 0):
        raise ValueError(f"indptr must rise from >= 0 to <= {len(indices)}")
    lo, hi = int(indptr[0]), int(indptr[-1])
    if hi > lo:
        used = indices[lo:hi]
        if int(used.min()) < 0 or int(used.max()) >= len(lut):
            raise IndexError(f"column index {int(used.max())} out of range for lut of length {len(lut)}")
    return indptr, indices, lut


def pack_csr(indptr, indices, data, lut, out_width: int, *, out=None) -> np.ndarray:
    """CSR rows -> (rows, out_width) dense rows in the packed layout, in ``data``'s dtype.

    Row ``r`` reads entries ``indptr[r]:indptr[r + 1]`` of ``indices`` and
    ``data`` (so ``indptr`` may be a slice of a larger matrix's).  Columns no
    kept gene maps to are zero.
    """
    indptr, indices, lut = _csr_arrays(indptr, indices, lut)
    data = _float_array(data, "data")
    if lut.max(initial=-1) >= out_width:
        raise IndexError(f"pack_csr: lut maps to column {int(lut.max())} >= out_width {out_width}")
    n_rows = len(indptr) - 1
    out = _out_buffer(out, (n_rows, out_width), data.dtype, "out")
    fn = getattr(library(), f"pack_csr_{_SUFFIX[data.dtype]}")
    fn(indptr.ctypes.data_as(_I64P), indices.ctypes.data_as(_I32P), data.ctypes.data, n_rows,
       lut.ctypes.data_as(_I64P), out_width, out.ctypes.data, _threads())
    pack_csr.calls += 1
    return out


pack_csr.calls = 0


def pack_dense(src, lut, out_width: int, *, out=None) -> np.ndarray:
    """Dense (rows, genes) -> (rows, out_width) in the packed layout, in ``src``'s dtype."""
    src = _float_array(src, "src")
    lut = np.ascontiguousarray(lut, dtype=np.int64)
    if src.ndim != 2:
        raise ValueError(f"src must be 2-D, got shape {src.shape}")
    n_rows, n_cols = src.shape
    if len(lut) < n_cols:
        raise IndexError(f"pack_dense: lut of length {len(lut)} shorter than {n_cols} input columns")
    if lut.max(initial=-1) >= out_width:
        raise IndexError(f"pack_dense: lut maps to column {int(lut.max())} >= out_width {out_width}")
    out = _out_buffer(out, (n_rows, out_width), src.dtype, "out")
    fn = getattr(library(), f"pack_dense_{_SUFFIX[src.dtype]}")
    fn(src.ctypes.data, n_rows, n_cols, lut.ctypes.data_as(_I64P), out_width, out.ctypes.data, _threads())
    pack_dense.calls += 1
    return out


pack_dense.calls = 0


def coo_remap(indptr, indices, data, lut, cap: int, col_dtype, *, bf16: bool = False, pad_col: int = 0, out=None):
    """CSR rows -> ``(cols, vals, counts, nnz)`` for the device densify.

    ``cols`` (cap,) holds the packed column of each kept nonzero, row-major,
    then ``pad_col``; ``vals`` (cap,) the values, then zeros — in ``data``'s
    dtype, or with ``bf16`` as bfloat16 bit patterns in uint16 (from float32
    data, rounded to nearest even; NaN becomes 0x7FC0 with its sign);
    ``counts`` (rows,) int32 the kept nonzeros per row.  ``col_dtype`` is
    uint16 or int32.  ``out`` is an optional ``(cols, vals, counts)`` triple
    of buffers of those shapes and dtypes.  Raises ``ValueError`` if the kept
    nonzeros exceed ``cap``.
    """
    indptr, indices, lut = _csr_arrays(indptr, indices, lut)
    data = _float_array(data, "data")
    col_dtype = np.dtype(col_dtype)
    if col_dtype not in (np.dtype(np.uint16), np.dtype(np.int32)):
        raise TypeError(f"col_dtype must be uint16 or int32, got {col_dtype}")
    if bf16 and data.dtype != np.float32:
        raise TypeError(f"bf16 values are rounded from float32 data, got {data.dtype}")
    if lut.max(initial=-1) > np.iinfo(col_dtype).max:
        raise IndexError(f"coo_remap: lut maps to column {int(lut.max())}, beyond {col_dtype}")
    n_rows = len(indptr) - 1
    cols, vals, counts = out if out is not None else (None, None, None)
    cols = _out_buffer(cols, (cap,), col_dtype, "cols")
    vals = _out_buffer(vals, (cap,), np.uint16 if bf16 else data.dtype, "vals")
    counts = _out_buffer(counts, (n_rows,), np.int32, "counts")
    offsets = np.empty(n_rows + 1, dtype=np.int64)
    fn = getattr(library(), f"coo_remap_{_SUFFIX[data.dtype]}")
    nnz = fn(indptr.ctypes.data_as(_I64P), indices.ctypes.data_as(_I32P), data.ctypes.data, n_rows,
             lut.ctypes.data_as(_I64P), cap, offsets.ctypes.data_as(_I64P), cols.ctypes.data,
             int(col_dtype.itemsize == 2), vals.ctypes.data, int(bf16), counts.ctypes.data_as(_I32P), _threads())
    if nnz < 0:
        raise ValueError(f"nnz_cap {cap} too small for batch with {-nnz} kept nonzeros")
    cols[nnz:] = pad_col
    vals[nnz:] = 0
    coo_remap.calls += 1
    return cols, vals, counts, int(nnz)


coo_remap.calls = 0


def dense_to_csr(arr) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense (rows, cols) f32/f64 -> CSR ``(data, indices, indptr)`` of its nonzeros.

    ``indptr`` and ``indices`` share one index dtype (scipy needs that):
    int32 unless the nonzeros overflow it.
    """
    arr = _float_array(arr, "arr")
    if arr.ndim != 2:
        raise ValueError(f"arr must be 2-D, got shape {arr.shape}")
    n_rows, n_cols = arr.shape
    lib = library()
    sfx = _SUFFIX[arr.dtype]
    threads = _threads()
    row_nnz = np.empty(n_rows, dtype=np.int64)
    getattr(lib, f"dense_nnz_rows_{sfx}")(arr.ctypes.data, n_rows, n_cols, row_nnz.ctypes.data_as(_I64P), threads)
    indptr = np.empty(n_rows + 1, dtype=np.int64)
    indptr[0] = 0
    np.cumsum(row_nnz, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = np.empty(nnz, dtype=np.int32)
    data = np.empty(nnz, dtype=arr.dtype)
    getattr(lib, f"dense_fill_csr_{sfx}")(arr.ctypes.data, n_rows, n_cols, indptr.ctypes.data_as(_I64P),
                                          indices.ctypes.data_as(_I32P), data.ctypes.data, threads)
    if nnz < 2**31 - 1:
        indptr = indptr.astype(np.int32)
    else:  # pragma: no cover - more than 2^31 nonzeros in one block
        indices = indices.astype(np.int64)
    dense_to_csr.calls += 1
    return data, indices, indptr


dense_to_csr.calls = 0
