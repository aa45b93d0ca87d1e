"""Exact per-row median (counterpart of ``infercnvpy_tpu/ops/pallas_select.py::row_median``).

The median has ``np.median`` semantics: for an even width it is the mean of
the two middle values (``torch.median`` would return the lower one).

Float ordering trick shared by both versions: for IEEE-754, mapping the
integer bit pattern ``i`` to ``key = i XOR (0x7FF..F AND (i >> bits-1))``
makes signed-integer order match total float order (negatives have their
lower bits flipped; -0 sorts just below +0).  The map is an involution.

* :func:`row_median_plain` sorts the keys (any device, f32 or f64);
* :func:`row_median_cuda` launches ``csrc/row_median.cu`` (f32, CUDA): one
  block per row, bisection over the keys with block-wide counts — the same
  ``__device__`` select routine as the fused kernel (``csrc/select.cuh``).
  Both return bit-identical results on the same input.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["row_median", "row_median_plain", "row_median_cuda", "float_key", "key_to_float"]

_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}


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


def row_median_cuda(x: torch.Tensor) -> torch.Tensor:
    """Exact per-row median of a 2-D f32 CUDA tensor (kernel ``row_median.cu``)."""
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"row_median_cuda takes a 2-D float32 CUDA tensor, got {x.dtype} on {x.device}")
    x = x.contiguous()
    n, w = x.shape
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0 or w == 0:
        return out.zero_()
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.row_median_launch(x.data_ptr(), out.data_ptr(), n, w, _build.current_stream(x.device))
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
