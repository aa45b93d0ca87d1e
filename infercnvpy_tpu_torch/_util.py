"""Small shared utilities (matrix-representation selection, device choice, logging).

Copied from ``infercnvpy_tpu/_util.py``; behavioural contract follows
reference: src/infercnvpy/_util.py:4-24.  ``pick_device``,
``pick_devices``, ``pick_shards`` and ``full_f32_matmul`` are the port's own.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np

from . import settings

__all__ = [
    "_ensure_array", "_choose_mtx_rep", "pick_device", "pick_devices", "pick_shards", "full_f32_matmul", "warn", "info",
]


def _ensure_array(a):
    """If ``a`` is a np.matrix, turn it into a plain ndarray (reference: _util.py:4-9)."""
    return np.asarray(a) if isinstance(a, np.matrix) else a


def _choose_mtx_rep(adata, use_raw: bool = False, layer: str | None = None):
    """Select the expression matrix: a named layer, ``raw.X``, or ``X``
    (same precedence and conflict rule as reference: _util.py:12-24)."""
    if use_raw and layer is not None:
        raise ValueError(f"use_raw=True conflicts with layer={layer!r}: pick one expression source")
    if layer is not None:
        return adata.layers[layer]
    return adata.raw.X if use_raw else adata.X


def _no_cuda(what: str) -> RuntimeError:
    return RuntimeError(
        f"{what} runs on a CUDA device by default and torch.cuda.is_available() is False: "
        'pass device="cpu" to run on the CPU'
    )


def pick_device(device, what: str):
    """One torch device for the entry point ``what``; ``None`` is the CUDA device and raises where there is none."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise _no_cuda(what)
        return torch.device("cuda")
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise ValueError(f"{what} runs on one device, got {len(device)}: {list(device)}")
        device = device[0]
    return torch.device(device)


def pick_devices(device, what: str) -> list:
    """The torch devices of the entry point ``what``, one per cell shard, as a list.

    ``device`` is a name, a ``torch.device``, or a list or tuple of either.
    A device may appear more than once: each entry is one shard, which is
    how one card (or the CPU) runs several.  ``None`` is every visible CUDA
    device and raises where there is none; an empty list, or devices of more
    than one type, raise ``ValueError``.
    """
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise _no_cuda(what)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in (device if isinstance(device, (list, tuple)) else [device])]
    if not devices:
        raise ValueError(f"{what}: the device list is empty")
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"{what}: devices of more than one type: {devices}")
    return devices


def pick_shards(device, what: str) -> list:
    """The devices of a downstream entry point ``what``, as a list.

    ``None`` and a single device are one device, as the JAX package's
    ``mesh=None`` is (``None``: the CUDA device, raising where there is
    none); a list or tuple shards the work over its entries
    (:func:`pick_devices`).
    """
    if device is None or not isinstance(device, (list, tuple)):
        return [pick_device(device, what)]
    return pick_devices(device, what)


@contextlib.contextmanager
def full_f32_matmul():
    """Run the enclosed float32 products in full float32 on CUDA (TF32 off), then restore the flag.

    TF32 keeps 10 mantissa bits: kNN distances and Gram matrices built from
    it miss the port's bars against float32 on the CPU.
    """
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def warn(msg: str):
    if settings.verbosity >= 1:
        print(f"WARNING: {msg}", file=sys.stderr)


def info(msg: str):
    if settings.verbosity >= 2:
        print(msg, file=sys.stderr)
