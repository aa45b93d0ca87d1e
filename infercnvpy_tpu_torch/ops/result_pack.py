"""Compression of the gated result matrix for the device-to-host copy.

Counterpart of ``infercnvpy_tpu/ops/result_pack.py`` (single device).  After
the noise gate the cell×window matrix is mostly exact zeros, so it is fetched
as

* a per-row **bitmask** of nonzero windows (1 bit per window: 32× smaller
  than dense f32), and
* the nonzero **values** compacted row-major into a capacity-padded flat
  array,

and scipy CSR is rebuilt on the host straight from the mask (bit positions
are the column indices), bit-identical to CSR-ifying the dense matrix.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["mask_nnz", "compact", "mask_vals_to_csr", "round_result_cap"]


def round_result_cap(nnz: int) -> int:
    """Round a survivor count up to the next power of two (floor 1024).

    The whole capacity-padded value buffer is fetched, so the cap bounds the
    padding at <2× the true nnz while keeping the buffer size stable across
    batches.
    """
    return max(1024, 1 << max(0, (int(nnz) - 1).bit_length()))


def mask_nnz(x: torch.Tensor, n_valid: int) -> tuple[torch.Tensor, int]:
    """``(mask, total_nnz)`` of the first ``n_valid`` rows.

    Padding rows after them pass the gate dense (their threshold comes from
    an unused chunk segment), so both this and :func:`compact` drop them.

    ``mask`` is (n_valid, 4·ceil(w/32)) uint8 on x's device: byte ``b`` bit
    ``j`` marks window ``8b + j``.  Viewed on a little-endian host as uint32 it
    is the (n_valid, ceil(w/32)) word mask :func:`mask_vals_to_csr` reads
    (the JAX package's ``mask_nnz_fn`` layout).
    """
    nz = x[:n_valid] != 0
    rows, w = nz.shape
    wpad = -(-w // 32) * 32
    if wpad != w:
        nz = torch.nn.functional.pad(nz, (0, wpad - w))
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = nz.reshape(rows, wpad // 8, 8).to(torch.uint8) << shifts
    mask = bits.sum(dim=-1, dtype=torch.uint8)
    return mask, int(nz.sum())


def compact(x: torch.Tensor, n_valid: int, cap: int) -> torch.Tensor:
    """Nonzeros of the first ``n_valid`` rows, row-major, zero-padded to ``cap``.

    Requires ``cap >=`` their count (the caller sizes it from :func:`mask_nnz`).
    """
    head = x[:n_valid]
    vals = head[head != 0]
    if vals.numel() > cap:
        raise ValueError(f"cap {cap} < {vals.numel()} nonzeros")
    out = torch.zeros(cap, dtype=x.dtype, device=x.device)
    out[: vals.numel()] = vals
    return out


def mask_vals_to_csr(mask: np.ndarray, vals: np.ndarray, n_windows: int) -> sp.csr_matrix:
    """Host half: (rows, nw32) uint32 mask + flat values -> scipy CSR.

    Bit k of ``mask[r, j]`` set means window ``32*j + k`` of row ``r`` is
    nonzero; values are stored row-major in the same order.
    """
    rows = mask.shape[0]
    # little-endian uint32 -> per-bit boolean, bit order preserved (the dtype
    # view needs a contiguous last axis)
    mask = np.ascontiguousarray(mask)
    bits = np.unpackbits(mask.view(np.uint8), bitorder="little").reshape(rows, -1)[:, :n_windows]
    row_nnz = bits.sum(axis=1, dtype=np.int64)
    indptr = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(row_nnz, out=indptr[1:])
    nnz = int(indptr[-1])
    flat_cols = np.flatnonzero(bits.reshape(-1))
    indices = (flat_cols % n_windows).astype(np.int32)
    data = np.array(vals[:nnz])  # a copy: ``vals`` may be a reused host buffer
    if nnz < 2**31 - 1:
        indptr = indptr.astype(np.int32)  # scipy needs ONE index dtype
    else:  # pragma: no cover - >2^31 nnz in one batch
        indices = indices.astype(np.int64)
    return sp.csr_matrix((data, indices, indptr), shape=(rows, n_windows))
