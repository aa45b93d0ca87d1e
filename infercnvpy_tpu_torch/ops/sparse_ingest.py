"""Device-side CSR densification (counterpart of ``infercnvpy_tpu/ops/sparse_ingest.py``).

The host only *remaps* CSR column indices through the packed-layout LUT and
ships three flat arrays — column ids (uint16 when the packed width allows),
values, and per-row counts — instead of a dense ``cells × packed_width``
block, 10–20× fewer bytes at single-cell densities (2–10 %).  The device
rebuilds the row ids with ``repeat_interleave`` and densifies with one
``index_add_`` into a zero block.

Numerics: each (row, packed column) receives at most one real value for
canonical CSR input, and padding entries carry value 0, so the densified
block is bit-identical to :func:`..ops.infercnv_kernel.pack_csr` whatever
order the device adds in.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["coo_from_csr_batch", "coo_from_csr_batch_plain", "col_index_dtype", "densify", "round_nnz_cap"]

#: nnz capacities are rounded up to a multiple of this, so the transfer
#: buffers of consecutive batches of similar density have one size
_NNZ_BUCKET = 1 << 20


def col_index_dtype(width: int):
    """Smallest integer dtype that can hold a packed column index."""
    return np.uint16 if width <= (1 << 16) else np.int32


def round_nnz_cap(nnz: int) -> int:
    """Round an nnz count up to the bucket size."""
    return max(_NNZ_BUCKET, ((nnz + _NNZ_BUCKET - 1) // _NNZ_BUCKET) * _NNZ_BUCKET)


def _is_bf16(val_dtype) -> bool:
    return str(val_dtype) in ("bf16", "bfloat16", "torch.bfloat16")


def coo_from_csr_batch(
    x: sp.spmatrix,
    lut: np.ndarray,
    width: int,
    nnz_cap: int | None = None,
    val_dtype=np.float32,
    *,
    rows: tuple[int, int] | None = None,
    out=None,
):
    """Host half of the sparse ingest: CSR batch -> flat transfer arrays, in native code.

    Returns ``(cols, vals, counts, nnz_kept)``:

    * ``cols``   — (nnz_cap,) packed column per kept nonzero, padded with
      ``width - 1`` (pad values are 0, so the device add is a no-op)
    * ``vals``   — (nnz_cap,) matching values, zero-padded; for a
      ``val_dtype`` of ``"bfloat16"``, bfloat16 bit patterns in uint16
      (rounded from float32, see ``native.coo_remap``)
    * ``counts`` — (n_rows,) int32 kept-nonzeros per row

    ``rows=(start, stop)`` takes that row range of ``x`` without slicing the
    matrix; ``out`` is an optional ``(cols, vals, counts)`` triple of buffers
    to write into.  Runs ``native.coo_remap`` (as
    ``infercnvpy_tpu/ops/sparse_ingest.py:71`` does);
    :func:`coo_from_csr_batch_plain` is its numpy reference.
    """
    from .. import native

    x = x.tocsr()
    start, stop = rows if rows is not None else (0, x.shape[0])
    ptr = x.indptr[start : stop + 1]
    lo, hi = int(ptr[0]), int(ptr[-1])
    bf16 = _is_bf16(val_dtype)
    data = x.data[lo:hi].astype(np.float32 if bf16 else val_dtype, copy=False)
    cap = nnz_cap if nnz_cap is not None else hi - lo
    cols, vals, counts, nnz = native.coo_remap(
        ptr - lo, x.indices[lo:hi], data, lut, cap, col_index_dtype(width), bf16=bf16, pad_col=width - 1, out=out
    )
    if nnz_cap is None:
        cols, vals = cols[:nnz], vals[:nnz]
    return cols, vals, counts, nnz


def coo_from_csr_batch_plain(
    x: sp.spmatrix,
    lut: np.ndarray,
    width: int,
    nnz_cap: int | None = None,
    val_dtype=np.float32,
):
    """numpy reference of :func:`coo_from_csr_batch` (float ``val_dtype`` only)."""
    x = x.tocsr()
    n_rows = x.shape[0]
    new_cols = lut[x.indices]
    row_nnz = np.diff(x.indptr)
    keep = new_cols >= 0
    if keep.all():
        counts = row_nnz.astype(np.int32)
        kept_cols = new_cols
        kept_vals = x.data
    else:
        rows_rep = np.repeat(np.arange(n_rows, dtype=np.int64), row_nnz)
        counts = np.bincount(rows_rep[keep], minlength=n_rows).astype(np.int32)
        kept_cols = new_cols[keep]
        kept_vals = x.data[keep]
    nnz = len(kept_cols)
    cap = nnz_cap if nnz_cap is not None else nnz
    if nnz > cap:
        raise ValueError(f"nnz_cap {cap} too small for batch with {nnz} kept nonzeros")
    cdt = col_index_dtype(width)
    cols = np.full(cap, width - 1, dtype=cdt)
    vals = np.zeros(cap, dtype=val_dtype)
    cols[:nnz] = kept_cols.astype(cdt)
    vals[:nnz] = kept_vals
    return cols, vals, counts, nnz


def densify(
    cols: torch.Tensor,
    vals: torch.Tensor,
    counts: torch.Tensor,
    nnz: int,
    width: int,
    dtype: torch.dtype,
) -> torch.Tensor:
    """Device half: flat arrays from :func:`coo_from_csr_batch` -> (rows, width) dense block.

    ``nnz`` is the number of real entries (``counts.sum()``), known on the
    host.  The ``len(cols) - nnz`` padding entries get the last row's id
    explicitly (``repeat_interleave`` needs its exact output size) and add 0.
    Flat indices are int64, so no batch size overflows them.
    """
    n_rows = counts.shape[0]
    dev = cols.device
    row_ids = torch.repeat_interleave(torch.arange(n_rows, device=dev), counts.long(), output_size=nnz)
    n_pad = cols.shape[0] - nnz
    if n_pad:
        row_ids = torch.cat([row_ids, torch.full((n_pad,), max(n_rows - 1, 0), dtype=torch.long, device=dev)])
    flat = row_ids * width + cols.long()
    dense = torch.zeros(n_rows * width, dtype=dtype, device=dev)
    dense.index_add_(0, flat, vals.to(dtype))
    return dense.view(n_rows, width)
