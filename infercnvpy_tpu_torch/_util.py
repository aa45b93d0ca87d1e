"""Small shared utilities (matrix-representation selection, logging).

Copied from ``infercnvpy_tpu/_util.py``; behavioural contract follows
reference: src/infercnvpy/_util.py:4-24.
"""

from __future__ import annotations

import sys

import numpy as np

from . import settings

__all__ = ["_ensure_array", "warn", "info"]


def _ensure_array(a):
    """If ``a`` is a np.matrix, turn it into a plain ndarray (reference: _util.py:4-9)."""
    return np.asarray(a) if isinstance(a, np.matrix) else a


def warn(msg: str):
    if settings.verbosity >= 1:
        print(f"WARNING: {msg}", file=sys.stderr)


def info(msg: str):
    if settings.verbosity >= 2:
        print(msg, file=sys.stderr)
