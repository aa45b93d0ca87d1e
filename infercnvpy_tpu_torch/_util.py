"""Small shared utilities (matrix-representation selection, device choice, logging).

Copied from ``infercnvpy_tpu/_util.py``; behavioural contract follows
reference: src/infercnvpy/_util.py:4-24.  ``pick_device`` and
``full_f32_matmul`` are the port's own.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np

from . import settings

__all__ = ["_ensure_array", "_choose_mtx_rep", "pick_device", "full_f32_matmul", "warn", "info"]


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


def pick_device(device, what: str):
    """One torch device for the entry point ``what``; ``None`` is the CUDA device and raises where there is none."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA device by default and torch.cuda.is_available() is False: "
                'pass device="cpu" to run on the CPU'
            )
        return torch.device("cuda")
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise NotImplementedError(
                "More than one device is not ported to infercnvpy_tpu_torch yet (ROADMAP.md: multi-device)."
            )
        device = device[0]
    return torch.device(device)


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
