"""Exact per-row selects (counterpart of ``infercnvpy_tpu/ops/pallas_select.py``).

``row_median``, ``row_median_weighted`` and ``row_kth_smallest``.  The
medians have ``np.median`` semantics: for an even count they are the mean of
the two middle values (``torch.median`` would return the lower one).

Float ordering trick shared by both versions: for IEEE-754, mapping the
integer bit pattern ``i`` to ``key = i XOR (0x7FF..F AND (i >> bits-1))``
makes signed-integer order match total float order (negatives have their
lower bits flipped; -0 sorts just below +0).  The map is an involution.

* the ``*_plain`` versions sort the keys (any device, f32 or f64);
* the ``*_cuda`` versions launch ``csrc/row_median.cu`` and
  ``csrc/row_select.cu`` (f32, CUDA): one block per row, a 4-pass radix
  select over the keys with (weighted) 256-bin histograms — the same
  ``__device__`` select routine as the fused and gene kernels
  (``csrc/select.cuh``).  Both return bit-identical results on the same input;
* :func:`radix_select_emulated` repeats that routine's arithmetic (digits,
  histograms, bin scan, the two ranks of an even total) in numpy, so the CPU
  tests can hold the algorithm against the key-sort versions.

Each dispatcher takes the kernel for a CUDA tensor (f32 only; anything else
raises) and the plain version for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = [
    "row_median", "row_median_plain", "row_median_cuda",
    "row_median_weighted", "row_median_weighted_plain", "row_median_weighted_cuda",
    "row_kth_smallest", "row_kth_smallest_plain", "row_kth_smallest_cuda",
    "float_key", "key_to_float", "radix_select_emulated", "median_ranks",
]

_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}

#: threads of a block of the standalone select kernels (a multiple of 32, at most 1024)
THREADS = 256
RADIX_BITS = 8  #: ``kRadixBits`` of ``csrc/select.cuh``


def float_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving signed-integer key of each float's bit pattern."""
    itype = _INT_OF[x.dtype]
    bits = torch.iinfo(itype).bits
    i = x.contiguous().view(itype)
    return i ^ (torch.iinfo(itype).max & (i >> (bits - 1)))


def key_to_float(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`float_key`."""
    itype = _INT_OF[dtype]
    bits = torch.iinfo(itype).bits
    i = key ^ (torch.iinfo(itype).max & (key >> (bits - 1)))
    return i.contiguous().view(dtype)


def row_median_plain(x: torch.Tensor) -> torch.Tensor:
    """Exact per-row median of a 2-D f32/f64 tensor by sorting the float keys."""
    n, w = x.shape
    if n == 0 or w == 0:
        return torch.zeros((n,), dtype=x.dtype, device=x.device)
    keys = torch.sort(float_key(x), dim=1).values
    k = w // 2
    hi = key_to_float(keys[:, k], x.dtype)
    if w % 2 == 1:
        return hi
    lo = key_to_float(keys[:, k - 1], x.dtype)
    return (lo + hi) / 2


def _check_cuda_f32(x: torch.Tensor, name: str) -> torch.Tensor:
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"{name} takes a 2-D float32 CUDA tensor, got {x.dtype} on {x.device}")
    return x.contiguous()


def row_median_cuda(x: torch.Tensor) -> torch.Tensor:
    """Exact per-row median of a 2-D f32 CUDA tensor (kernel ``row_median.cu``)."""
    x = _check_cuda_f32(x, "row_median_cuda")
    n, w = x.shape
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0 or w == 0:
        return out.zero_()
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.row_median_launch(x.data_ptr(), out.data_ptr(), n, w, THREADS, _build.current_stream(x.device))
    _build.check(err, "row_median")
    row_median_cuda.launches += 1
    return out


row_median_cuda.launches = 0


def row_median(x: torch.Tensor) -> torch.Tensor:
    """Exact per-row median: the CUDA kernel for a CUDA tensor, the plain sort on the CPU.

    A CUDA tensor that is not f32 raises (the kernel takes f32 only).
    """
    if x.is_cuda:
        return row_median_cuda(x)
    return row_median_plain(x)


def _weights(weights, w: int, device) -> tuple[torch.Tensor, int]:
    """``(int64 weights on device, total)``; raises on a bad shape or a negative weight."""
    wts = torch.as_tensor(weights).to(device=device, dtype=torch.int64)
    if tuple(wts.shape) != (w,):
        raise ValueError(f"weights must have shape ({w},), got {tuple(wts.shape)}")
    if bool((wts < 0).any()):
        raise ValueError("weights must be >= 0")
    return wts, int(wts.sum())


def row_median_weighted_plain(x: torch.Tensor, weights) -> torch.Tensor:
    """Exact per-row ``np.median(np.repeat(row, weights))`` of a 2-D f32/f64 tensor.

    ``weights`` — (w,) non-negative integers; a zero weight drops its column.
    A weight total of 0, or no rows, gives zeros.  Sorts the float keys and
    finds ranks ``total // 2`` (and the one below it for an even total) in the
    running weight sum.
    """
    n, w = x.shape
    wts, total = _weights(weights, w, x.device)
    if n == 0 or total == 0:
        return torch.zeros((n,), dtype=x.dtype, device=x.device)
    keys, order = torch.sort(float_key(x), dim=1)
    cum = torch.cumsum(wts[order], dim=1)

    def rank(r: int) -> torch.Tensor:
        # first sorted position whose running weight exceeds r: it has weight > 0
        target = torch.full((n, 1), r + 1, dtype=cum.dtype, device=x.device)
        pos = torch.searchsorted(cum, target)
        return key_to_float(keys.gather(1, pos)[:, 0], x.dtype)

    k_hi = total // 2
    hi = rank(k_hi)
    if total % 2 == 1:
        return hi
    return (rank(k_hi - 1) + hi) / 2


def row_median_weighted_cuda(x: torch.Tensor, weights) -> torch.Tensor:
    """Exact per-row weighted median of a 2-D f32 CUDA tensor (kernel ``row_select.cu``)."""
    x = _check_cuda_f32(x, "row_median_weighted_cuda")
    n, w = x.shape
    wts, total = _weights(weights, w, x.device)
    if total > torch.iinfo(torch.int32).max:
        raise ValueError(f"weight total {total} does not fit the kernel's int32 counts")
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0 or total == 0:
        return out.zero_()
    wts = wts.to(torch.int32)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.row_median_weighted_launch(
            x.data_ptr(), wts.data_ptr(), out.data_ptr(), n, w, total, THREADS, _build.current_stream(x.device)
        )
    _build.check(err, "row_median_weighted")
    row_median_weighted_cuda.launches += 1
    return out


row_median_weighted_cuda.launches = 0


def row_median_weighted(x: torch.Tensor, weights) -> torch.Tensor:
    """Exact per-row ``np.median(np.repeat(row, weights))``: the kernel on CUDA, the plain sort on the CPU."""
    if x.is_cuda:
        return row_median_weighted_cuda(x, weights)
    return row_median_weighted_plain(x, weights)


def _check_k(k: int, w: int) -> int:
    k = int(k)
    if not 0 <= k < w:
        raise ValueError(f"k={k} is outside [0, {w}): a row of {w} values has no such element")
    return k


def row_kth_smallest_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact per-row k-th smallest (0-based) of a 2-D f32/f64 tensor by sorting the float keys."""
    n, w = x.shape
    k = _check_k(k, w)
    keys = torch.sort(float_key(x), dim=1).values
    return key_to_float(keys[:, k], x.dtype)


def row_kth_smallest_cuda(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact per-row k-th smallest of a 2-D f32 CUDA tensor (kernel ``row_select.cu``)."""
    x = _check_cuda_f32(x, "row_kth_smallest_cuda")
    n, w = x.shape
    k = _check_k(k, w)
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.row_kth_smallest_launch(
            x.data_ptr(), out.data_ptr(), n, w, k, THREADS, _build.current_stream(x.device)
        )
    _build.check(err, "row_kth_smallest")
    row_kth_smallest_cuda.launches += 1
    return out


row_kth_smallest_cuda.launches = 0


def row_kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact per-row k-th smallest (0-based): the kernel on CUDA, the plain sort on the CPU."""
    if x.is_cuda:
        return row_kth_smallest_cuda(x, k)
    return row_kth_smallest_plain(x, k)


def median_ranks(total: int) -> tuple[int, int]:
    """The two 0-based ranks an ``np.median`` over ``total`` values averages (equal for an odd total)."""
    k_hi = total // 2
    return (k_hi if total % 2 else k_hi - 1), k_hi


def _scan_bins(hist: np.ndarray, k: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per row: the smallest bin ``d`` with ``hist[:d + 1].sum() > k``, and ``k`` minus the bins before it."""
    cum = np.cumsum(hist, axis=1)
    if not (cum[:, -1] > k).all():
        raise ValueError("rank beyond the weight the histogram holds")
    d = (cum > k[:, None]).argmax(axis=1)
    before = np.where(d > 0, cum[np.arange(len(d)), np.maximum(d - 1, 0)], 0)
    return d, k - before


def radix_select_emulated(x: np.ndarray, weights, rank_lo: int, rank_hi: int) -> tuple[np.ndarray, np.ndarray]:
    """``csrc/select.cuh::block_select2`` in numpy: per row the elements of ranks ``rank_lo <= rank_hi``.

    ``x`` is (rows, w) float32; ``weights`` is ``None`` (every value counts
    once) or (w,) non-negative integers (value ``i`` counts ``weights[i]``
    times, zero drops it).  Most-significant-digit radix select on the
    order-preserving unsigned keys, :data:`RADIX_BITS` bits a pass: a pass
    adds the weight of every value that still matches a rank's prefix to that
    rank's histogram, then scans the bins for the digit holding the rank.  The
    two ranks share a histogram while their prefixes agree and get one each
    from the pass after the one in which they part.  Returns the two (rows,)
    float32 arrays; both are elements of the row, bit for bit.
    """
    x = np.ascontiguousarray(x, dtype=np.float32)
    rows, w = x.shape
    wts = np.ones(w, np.int64) if weights is None else np.asarray(weights, dtype=np.int64)
    i = x.view(np.int32)
    key = (i ^ (0x7FFFFFFF & (i >> 31))).view(np.uint32) ^ np.uint32(0x80000000)
    live = np.broadcast_to(wts > 0, key.shape)
    wmat = np.broadcast_to(wts, key.shape)
    bins = 1 << RADIX_BITS
    row_of = np.broadcast_to(np.arange(rows)[:, None], key.shape)
    pre = {"lo": np.zeros(rows, np.uint32), "hi": np.zeros(rows, np.uint32)}
    k = {"lo": np.full(rows, rank_lo, np.int64), "hi": np.full(rows, rank_hi, np.int64)}
    for p in range(32 // RADIX_BITS):
        shift = 32 - RADIX_BITS * (p + 1)
        above = np.uint32(0) if p == 0 else np.uint32((0xFFFFFFFF << (shift + RADIX_BITS)) & 0xFFFFFFFF)
        digit = ((key >> np.uint32(shift)) & np.uint32(bins - 1)).astype(np.int64)
        parted = pre["lo"] != pre["hi"]
        in_hi = live & ((key & above) == pre["hi"][:, None])
        in_lo = live & ~in_hi & parted[:, None] & ((key & above) == pre["lo"][:, None])
        hist = {}
        for name, member in (("hi", in_hi), ("lo", in_lo)):
            h = np.zeros((rows, bins), np.int64)
            np.add.at(h, (row_of[member], digit[member]), wmat[member])
            hist[name] = h
        hist["lo"] = np.where(parted[:, None], hist["lo"], hist["hi"])
        for name in ("hi", "lo"):
            d, k[name] = _scan_bins(hist[name], k[name])
            pre[name] = pre[name] | (d.astype(np.uint32) << np.uint32(shift))
    out = []
    for name in ("lo", "hi"):
        s = (pre[name] ^ np.uint32(0x80000000)).view(np.int32)
        out.append((s ^ (0x7FFFFFFF & (s >> 31))).view(np.float32))
    return out[0], out[1]
