"""Device lists for cell-sharded execution (counterpart of ``infercnvpy_tpu/parallel/mesh.py``).

The JAX package places cell shards on a 1-D ``jax.sharding.Mesh``.  Here a
"mesh" is an ordered list of torch devices, one entry per cell shard: shard
``i`` owns the ``i``-th contiguous range of rows (:func:`shard_rows`), and the
same device may appear more than once (several shards on one card, or on the
CPU).  What the JAX package replicates is copied once to each distinct device
(:func:`replicate`).
"""

from __future__ import annotations

import numpy as np
import torch

from .._util import pick_devices

__all__ = ["cell_mesh", "mesh_key", "pad_rows", "replicate", "shard_rows"]


def cell_mesh(devices=None) -> list[torch.device]:
    """The ordered device list of a cell-sharded run (``infercnvpy_tpu/parallel/mesh.py:112-126``).

    ``None`` is every visible CUDA device, and raises where there is none; a
    device name, a ``torch.device``, or a list or tuple of either is taken as
    given (see ``_util.pick_devices``).
    """
    return pick_devices(devices, "cell_mesh")


def _canonical(device: torch.device) -> str:
    """``cuda`` and ``cuda:<current>`` name one card: key both as the latter."""
    if device.type == "cuda" and device.index is None:
        return f"cuda:{torch.cuda.current_device()}"
    return str(device)


def mesh_key(devices) -> tuple:
    """Hashable identity of a device list, the cache key of the sharded transforms."""
    return tuple(_canonical(torch.device(d)) for d in devices)


def pad_rows(a: np.ndarray, mult: int) -> np.ndarray:
    """Zero-pad the leading axis to a multiple of ``mult`` (no-op if aligned)."""
    pad = (-a.shape[0]) % mult
    if pad:
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)
    return a


def shard_rows(n: int, n_dev: int) -> list[tuple[int, int]]:
    """Contiguous ``(start, stop)`` row ranges of ``n`` rows over ``n_dev`` shards, in device order.

    Shard sizes differ by at most one row, the larger first; with ``n`` a
    multiple of ``n_dev`` (``tl.infercnv`` pads to one) every shard holds
    ``n // n_dev`` rows, as the JAX package's ``P("cells")`` splits them.
    """
    if n_dev < 1:
        raise ValueError(f"n_dev must be >= 1, got {n_dev}")
    base, extra = divmod(int(n), int(n_dev))
    bounds = np.cumsum([0] + [base + (i < extra) for i in range(n_dev)])
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def replicate(t: torch.Tensor, devices) -> list[torch.Tensor]:
    """``t`` on every device of the list, one copy per distinct device, aligned with ``devices``."""
    copies: dict[str, torch.Tensor] = {}
    out = []
    for d in devices:
        key = _canonical(torch.device(d))
        if key not in copies:
            copies[key] = t.to(d)
        out.append(copies[key])
    return out
