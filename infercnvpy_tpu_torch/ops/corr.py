"""Pairwise Pearson correlation of rows on the device (counterpart of ``infercnvpy_tpu/ops/corr.py``).

Used by ``tl.ithcna`` / ``tl.ithgex`` (the reference computes float64
``np.corrcoef`` on the host, tl/_scores.py:137,207): rows are standardised
and the correlations are one (cells × cells) product, all in float64 on the
device — the JAX package's x64 branch, which matches ``np.corrcoef`` to
~1e-13.  Given a list of devices, each computes one row stripe of the product
against the whole standardised matrix (``infercnvpy_tpu/ops/corr.py:43-110``).
The JAX package's double-float32 branch for backends without float64 is not
carried.
"""

from __future__ import annotations

import numpy as np
import torch

from .._util import pick_shards
from ..parallel.mesh import replicate, shard_rows

__all__ = ["pearson_rows"]


def pearson_rows(X, *, device=None) -> np.ndarray:
    """Correlation matrix of the rows of X (``np.corrcoef`` semantics), float64 on the host.

    ``device=None`` is the CUDA device; a list of devices splits the rows of
    the product into contiguous stripes, one a device.
    """
    devices = pick_shards(device, "pearson_rows")
    Xd = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float64)).to(devices[0])
    Xd = Xd - Xd.mean(dim=1, keepdim=True)
    Xn = Xd / torch.sqrt((Xd * Xd).sum(dim=1, keepdim=True))
    ranges = shard_rows(Xn.shape[0], len(devices))
    stripes = [torch.clamp(xn[lo:hi] @ xn.T, -1.0, 1.0) for xn, (lo, hi) in zip(replicate(Xn, devices), ranges)]
    if len(stripes) == 1:
        return stripes[0].cpu().numpy()
    out = np.empty((Xn.shape[0], Xn.shape[0]))
    for stripe, (lo, hi) in zip(stripes, ranges):
        out[lo:hi] = stripe.cpu().numpy()
    return out
