"""The port's native libraries, built with g++ at first use and loaded via ctypes.

* ``pack.cpp`` — the host packers (counterpart of the pack half of
  ``infercnvpy_tpu/native/__init__.py``);
* ``leiden.cpp`` — Leiden clustering, the JAX package's source built with the
  JAX package's flags, so both give the same labels for the same graph and
  seed.

Each library goes into the gitignored ``infercnvpy_tpu_torch/_build/`` under
a name that carries a hash of its source and flags; the build writes a
temporary file and renames it, so concurrent processes never load a partial
library.  A failed build raises with g++'s stderr: nothing falls back to
numpy or Python.  The numpy versions in ``ops/sparse_ingest.py`` and
``ops/infercnv_kernel.py``, ``ops/leiden.py::leiden_plain`` and scipy's
mean in ``tl/_infercnv.py::_mean0`` are the references the tests hold these
against.

Every packer wrapper checks dtypes, shapes and index bounds before it passes
a pointer (the C scatters are unchecked; ``count_in_columns`` and
``reference_sums`` check each column id themselves before they use it),
runs on ``torch.get_num_threads()`` OpenMP threads (``mask_to_csr`` on
``threads`` when given, ``reference_sums`` on one a slot), releases the GIL
for the call (ctypes does), counts its calls in ``.calls``, and can write into
caller-owned ``out`` buffers, such as pinned host memory, which it overwrites
completely (``mask_to_csr`` writes only its rows' slots of the call's arrays).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .. import profiling

__all__ = [
    "library", "build", "pack_csr", "pack_dense", "coo_remap", "dense_to_csr", "count_in_columns", "reference_sums",
    "GXX_FLAGS",
    "leiden_library", "build_leiden", "leiden", "LEIDEN_FLAGS",
]

_SRC = Path(__file__).resolve().parent / "pack.cpp"
_LEIDEN_SRC = Path(__file__).resolve().parent / "leiden.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
#: ``-ffp-contract=off``: ``reference_sums`` rounds each product before it adds it, as numpy and scipy do
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp", "-ffp-contract=off")
#: the flags of ``infercnvpy_tpu/native/__init__.py::_build_library``: the same code gives the same labels
LEIDEN_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

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
    # mask_ptrs, val_ptrs, seg_rows, seg_nnz, n_seg, n_words, n_windows, cap, indptr, indices, data, n_threads
    "mask_to_csr": (_I64, (_P, _P, _I64P, _I64P, _I64, _I64, _I64, _I64, _I64P, _I32P, _P, _I32)),
}
_SUFFIX = {np.dtype(np.float32): "f32", np.dtype(np.float64): "f64"}
#: ``reference_sums_f64``'s code of each value type it reads
_F64_SOURCES = {np.dtype(t): k for k, t in enumerate(
    (np.float64, np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32, np.uint64))}

_LIB = None
_LEIDEN_LIB = None


def _build(src: Path, stem: str, flags: tuple[str, ...]) -> Path:
    """Compile ``src`` if no library for the current source and flags exists; return its path."""
    tag = hashlib.sha256(repr(flags).encode() + src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{stem}-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *flags, str(src), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build() -> Path:
    """Compile ``pack.cpp`` if no library for the current source exists; return its path."""
    return _build(_SRC, "infercnv_pack", GXX_FLAGS)


def build_leiden() -> Path:
    """Compile ``leiden.cpp`` if no library for the current source exists; return its path."""
    return _build(_LEIDEN_SRC, "infercnv_leiden", LEIDEN_FLAGS)


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
        # indices, n, keep, n_cols, n_threads
        lib.count_in_columns.restype = _I64
        lib.count_in_columns.argtypes = [_I32P, _I64, _P, _I64, _I32]
        # indptr, indices, data, [source,] nnz, n_rows, slot, n_slots, scale, n_cols, out, n_threads
        lib.reference_sums_f32.restype = lib.reference_sums_f64.restype = _I64
        lib.reference_sums_f32.argtypes = [_I64P, _I32P, _P, _I64, _I64, _I32P, _I64, _P, _I64, _P, _I32]
        lib.reference_sums_f64.argtypes = [_I64P, _I32P, _P, _I32, _I64, _I64, _I32P, _I64, _P, _I64, _P, _I32]
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


def mask_to_csr(masks, vals, seg_nnz, n_windows: int, indptr, indices, data, *, row: int = 0,
                threads: int | None = None) -> int:
    """The result pack's word masks and compacted values -> CSR rows, written into caller-owned arrays.

    ``masks[s]`` is shard ``s``'s (rows, ceil(n_windows / 32)) uint32 word
    mask (bit ``k`` of word ``j`` marks window ``32 j + k``; bits at or past
    ``n_windows`` are ignored) and ``vals[s]`` its compacted values, of which
    the first ``seg_nnz[s]`` are real; the shards' rows follow one another.
    The rows' ends go to ``indptr[row + 1 : row + rows + 1]`` (int64, offsets
    into the whole arrays, continuing from ``indptr[row]``) and their column
    ids and values to ``indices`` (int32) and ``data`` from ``indptr[row]`` on.
    The arrays it writes equal ``ops.result_pack.sharded_mask_vals_to_csr``'s
    (``mask_vals_to_csr``'s for one shard), shifted by the offsets.  Runs on
    ``threads`` OpenMP threads (default torch's count); returns the values
    written.
    """
    if indptr.dtype != np.int64 or indices.dtype != np.int32 or data.dtype not in _SUFFIX \
            or not (indptr.flags.c_contiguous and indices.flags.c_contiguous and data.flags.c_contiguous) \
            or indptr.ndim != 1 or indices.shape != data.shape or indices.ndim != 1:
        raise ValueError("indptr (int64), indices (int32) and data (float32 / float64 of indices' length) must be "
                         "C-contiguous 1-D arrays")
    n_words = -(-int(n_windows) // 32)
    seg_rows = np.array([m.shape[0] for m in masks], dtype=np.int64)
    seg_nnz = np.ascontiguousarray(seg_nnz, dtype=np.int64)
    if len(masks) != len(vals) or len(seg_nnz) != len(masks):
        raise ValueError(f"{len(masks)} masks, {len(vals)} value arrays and {len(seg_nnz)} counts")
    for m, v, k in zip(masks, vals, seg_nnz):
        if m.dtype != np.uint32 or m.ndim != 2 or m.shape[1] != n_words or not m.flags.c_contiguous:
            raise ValueError(f"a mask must be a C-contiguous (rows, {n_words}) uint32 array, got {m.dtype} {m.shape}")
        if v.dtype != data.dtype or v.ndim != 1 or not v.flags.c_contiguous or not 0 <= k <= len(v):
            raise ValueError(f"values must be C-contiguous 1-D {data.dtype} holding their count {k}, "
                             f"got {v.dtype} {v.shape}")
    rows = int(seg_rows.sum())
    if row < 0 or row + rows + 1 > len(indptr):
        raise ValueError(f"rows {row}..{row + rows} past indptr of length {len(indptr)}")
    total = int(seg_nnz.sum())
    if int(indptr[row]) + total > len(indices):
        raise ValueError(f"{total} values from offset {int(indptr[row])} pass the arrays' length {len(indices)}")
    threads = _threads() if threads is None else int(threads)
    mask_ptrs = np.array([m.ctypes.data for m in masks], dtype=np.uint64)
    val_ptrs = np.array([v.ctypes.data for v in vals], dtype=np.uint64)
    fn = getattr(library(), f"mask_to_csr_{_SUFFIX[data.dtype]}")
    n = fn(mask_ptrs.ctypes.data, val_ptrs.ctypes.data, seg_rows.ctypes.data_as(_I64P),
           seg_nnz.ctypes.data_as(_I64P), len(masks), n_words, int(n_windows), len(indices),
           indptr[row:].ctypes.data_as(_I64P), indices.ctypes.data_as(_I32P), data.ctypes.data, max(1, threads))
    if n == -1:
        raise ValueError("a mask's bits do not count its shard's values")
    if n < 0:  # pragma: no cover - the capacity is checked above
        raise ValueError("the values pass the arrays' length")
    mask_to_csr.calls += 1
    return int(n)


mask_to_csr.calls = 0


def count_in_columns(indices, keep) -> int:
    """How many of the column ids ``indices`` lie in a column that ``keep`` (one flag a column) marks.

    A CSR row range's nonzeros in the kept genes, counted without a copy of
    the range; the plain version is ``np.count_nonzero(keep[indices])``.
    """
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    keep = np.ascontiguousarray(keep, dtype=np.uint8)
    n = library().count_in_columns(indices.ctypes.data_as(_I32P), len(indices), keep.ctypes.data, len(keep),
                                   _threads())
    if n < 0:
        raise IndexError(f"count_in_columns: a column index lies outside [0, {len(keep)})")
    count_in_columns.calls += 1
    return int(n)


count_in_columns.calls = 0


def reference_sums(indptr, indices, data, slot, scale, n_cols: int) -> tuple[np.ndarray, int]:
    """Each slot's sum of its CSR rows' scaled values: ``(sums, entries summed)``, ``sums`` of shape
    ``(len(scale), n_cols)``.

    Row ``r`` belongs to slot ``slot[r]`` (int32; a value outside
    ``[0, len(scale))`` puts it in none, and it is not read).  A slot's rows
    are summed in ascending order, each entry as ``x * scale[s]`` into one
    accumulator a slot and column, in ``data``'s dtype (float64 for integer
    data): with ``scale[s]`` the dtype's ``1 / rows``, the row is scipy's
    ``X[rows].mean(axis=0)`` bit for bit (scipy 1.18 first sums a row's
    float entries of one column, so a row that repeats a column id can
    differ there in the last bits).  ``indices`` must be int32 and
    ``data`` float32, float64 or integer, both read where they lie (neither
    is converted or copied); ``indptr`` is taken as int64.  Runs one thread
    a slot, at most ``torch.get_num_threads()``.  Raises ``IndexError`` if a
    row range or a column id among the rows read lies out of bounds.
    """
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices)
    data = np.ascontiguousarray(data)
    slot = np.ascontiguousarray(slot, dtype=np.int32)
    if indices.dtype != np.int32 or indices.ndim != 1 or data.shape != indices.shape:
        raise TypeError(f"indices must be 1-D int32 with data's shape, got {indices.dtype} {indices.shape} "
                        f"beside {data.shape}")
    if data.dtype not in _SUFFIX and data.dtype not in _F64_SOURCES:
        raise TypeError(f"data must be float32, float64 or integer, got {data.dtype}")
    n_rows = len(indptr) - 1
    if n_rows < 0 or slot.shape != (n_rows,):
        raise ValueError(f"slot must hold one entry a row: {slot.shape} for {max(n_rows, 0)} rows")
    dtype = np.dtype(np.float32) if data.dtype == np.float32 else np.dtype(np.float64)
    scale = np.ascontiguousarray(scale, dtype=dtype)
    n_slots = len(scale)
    out = np.empty((n_slots, int(n_cols)), dtype=dtype)
    lib = library()
    head = (indptr.ctypes.data_as(_I64P), indices.ctypes.data_as(_I32P), data.ctypes.data)
    tail = (len(indices), n_rows, slot.ctypes.data_as(_I32P), n_slots, scale.ctypes.data, int(n_cols),
            out.ctypes.data, max(1, min(n_slots, _threads())))
    if dtype == np.float32:
        n = lib.reference_sums_f32(*head, *tail)
    else:
        n = lib.reference_sums_f64(*head, _F64_SOURCES[data.dtype], *tail)
    if n < 0:
        raise IndexError(f"reference_sums: a row range or a column id lies outside {len(indices)} entries "
                         f"of {int(n_cols)} columns")
    reference_sums.calls += 1
    return out, int(n)


reference_sums.calls = 0


def leiden_library() -> ctypes.CDLL:
    """The loaded Leiden library (built on first call)."""
    global _LEIDEN_LIB
    if _LEIDEN_LIB is None:
        lib = ctypes.CDLL(str(build_leiden()))
        lib.leiden_cluster.restype = _I64
        # indptr, indices, weights, n_nodes, resolution, seed, max_rounds, labels_out
        lib.leiden_cluster.argtypes = [_I64P, _I32P, ctypes.POINTER(ctypes.c_double), _I64, ctypes.c_double,
                                       ctypes.c_uint64, _I64, _I64P]
        _LEIDEN_LIB = lib
    return _LEIDEN_LIB


def leiden(indptr, indices, weights, *, resolution: float, seed: int, max_rounds: int) -> np.ndarray:
    """Leiden labels (int64, 0 = the largest cluster) of the undirected graph in CSR form.

    The graph must be symmetric with sorted indices, as ``ops.leiden.leiden``
    passes it; ``seed`` seeds the library's ``std::mt19937_64``.
    """
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    n = len(indptr) - 1
    if n < 0 or indptr[0] != 0 or indptr[-1] != len(indices) or len(weights) != len(indices) \
            or np.any(np.diff(indptr) < 0):
        raise ValueError(f"not a CSR graph: indptr of length {len(indptr)} over {len(indices)} indices, "
                         f"{len(weights)} weights")
    if len(indices) and (int(indices.min()) < 0 or int(indices.max()) >= n):
        raise IndexError(f"neighbour index out of range for {n} nodes")
    labels = np.empty(n, dtype=np.int64)
    communities = leiden_library().leiden_cluster(
        indptr.ctypes.data_as(_I64P), indices.ctypes.data_as(_I32P),
        weights.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, float(resolution), int(seed),
        int(max_rounds), labels.ctypes.data_as(_I64P),
    )
    profiling.count("leiden_communities", int(communities))
    return labels
