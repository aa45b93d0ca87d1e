"""Compression of the gated result matrix for the device-to-host copy.

Counterpart of ``infercnvpy_tpu/ops/result_pack.py``.  After
the noise gate the cell×window matrix is mostly exact zeros, so it is fetched
as

* a per-row **bitmask** of nonzero windows (1 bit per window: 32× smaller
  than dense f32), and
* the nonzero **values** compacted row-major into a capacity-padded flat
  array,

and scipy CSR is rebuilt on the host straight from the mask (bit positions
are the column indices), bit-identical to CSR-ifying the dense matrix.  On
cell shards (``parallel``) each shard masks and compacts its own rows into
its own ``cap`` slots (:func:`sharded_mask_nnz`, :func:`sharded_compact`),
and the host joins the segments in shard order.  ``tl.infercnv`` rebuilds
the CSR in native code (``native.mask_to_csr``, reading each shard's mask and
segment where they were downloaded); :func:`mask_vals_to_csr` and
:func:`sharded_mask_vals_to_csr` are the plain versions the tests hold it
against.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .. import profiling

__all__ = [
    "mask_nnz", "compact", "mask_vals_to_csr", "round_result_cap",
    "sharded_mask_nnz", "sharded_compact", "sharded_mask_vals_to_csr",
]


def round_result_cap(nnz: int) -> int:
    """Round a survivor count up to the next power of two (floor 1024).

    The whole capacity-padded value buffer is fetched, so the cap bounds the
    padding at <2× the true nnz while keeping the buffer size stable across
    batches.
    """
    return max(1024, 1 << max(0, (int(nnz) - 1).bit_length()))


def _mask(x: torch.Tensor, n_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mask, nnz)`` of the first ``n_valid`` rows, ``nnz`` still on the device."""
    nz = x[:n_valid] != 0
    rows, w = nz.shape
    wpad = -(-w // 32) * 32
    if wpad != w:
        nz = torch.nn.functional.pad(nz, (0, wpad - w))
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = nz.reshape(rows, wpad // 8, 8).to(torch.uint8) << shifts
    return bits.sum(dim=-1, dtype=torch.uint8), nz.sum()


def mask_nnz(x: torch.Tensor, n_valid: int) -> tuple[torch.Tensor, int]:
    """``(mask, total_nnz)`` of the first ``n_valid`` rows.

    Padding rows after them pass the gate dense (their threshold comes from
    an unused chunk segment), so both this and :func:`compact` drop them.

    ``mask`` is (n_valid, 4·ceil(w/32)) uint8 on x's device: byte ``b`` bit
    ``j`` marks window ``8b + j``.  Viewed on a little-endian host as uint32 it
    is the (n_valid, ceil(w/32)) word mask :func:`mask_vals_to_csr` reads
    (the JAX package's ``mask_nnz_fn`` layout).
    """
    mask, nnz = _mask(x, n_valid)
    return mask, int(nnz)


def _shard_local_valid(n_valid: int, start: int, rows: int) -> int:
    """The global valid-row count in the frame of the shard of ``rows`` rows from global row ``start``.

    Padding rows sit at the global tail, so a shard's valid rows are its first
    ``n_valid - start`` (clamped to ``[0, rows]``).  The mask and compact
    passes share it: they must agree, or the rebuilt CSR desynchronises
    (``infercnvpy_tpu/ops/result_pack.py:99-110``).
    """
    return min(max(n_valid - start, 0), rows)


def _shard_starts(xs) -> list[int]:
    return np.cumsum([0] + [x.shape[0] for x in xs[:-1]]).tolist()


def sharded_mask_nnz(xs: list[torch.Tensor], n_valid: int) -> tuple[list[torch.Tensor], list[int]]:
    """:func:`mask_nnz` of each shard's valid rows: ``(masks, shard_nnz)``, the masks on their devices.

    ``xs`` are the shards' row blocks in global row order and ``n_valid`` the
    global count of valid rows.  Every shard's mask is started before any
    count is read, so the devices overlap.
    """
    parts = [_mask(x, _shard_local_valid(n_valid, s, x.shape[0])) for x, s in zip(xs, _shard_starts(xs))]
    with profiling.span("infercnv.wait", on="compute"):  # the counts' readback waits for the devices
        nnz = [int(k) for _, k in parts]
    return [m for m, _ in parts], nnz


def sharded_compact(xs: list[torch.Tensor], n_valid: int, cap: int) -> list[torch.Tensor]:
    """:func:`compact` of each shard's valid rows into its own ``cap`` slots, on its device."""
    return [compact(x, _shard_local_valid(n_valid, s, x.shape[0]), cap) for x, s in zip(xs, _shard_starts(xs))]


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


def sharded_mask_vals_to_csr(
    mask: np.ndarray, vals: np.ndarray, shard_nnz, n_windows: int
) -> sp.csr_matrix:
    """Host assembly of the sharded pack (``infercnvpy_tpu/ops/result_pack.py:159-168``).

    ``mask`` holds the shards' word masks in global row order, ``vals`` the
    shards' ``cap``-slot value segments one after another, and ``shard_nnz``
    each segment's count of real values.
    """
    n_dev = len(shard_nnz)
    cap = len(vals) // n_dev
    data = np.concatenate([vals[s * cap : s * cap + int(shard_nnz[s])] for s in range(n_dev)])
    return mask_vals_to_csr(mask, data, n_windows)


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
