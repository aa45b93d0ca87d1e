"""Exact k-nearest neighbours: tiled products, running top-k merge (counterpart of ``infercnvpy_tpu/ops/knn.py``).

Replaces the reference's pynndescent/numba approximate kNN (reference:
pp/__init__.py:43 via scanpy).  Squared distances are one product per
(query block × database block) tile, ``|q|² + |x|² − 2 q·xᵀ``, and a running
``torch.topk`` merge keeps memory at one tile whatever the cell count.  The
products run in full float32 (TF32 off): TF32's 10 mantissa bits move
distances by ~1e-3 relative and reorder neighbours.  Given a list of
devices, every device holds the whole database and the query blocks go to
the devices in turn (the JAX package's ``mesh`` branch,
``infercnvpy_tpu/ops/knn.py:54-79, 114-138``); each query block is the same
tile set on any device, so the result equals one device's.

Ties: rows with equal distances (identical cells, common in a gated CNV
matrix) may list tied neighbours in another order than the JAX package's
``lax.top_k``; the sorted distances and every untied neighbour agree.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import profiling
from .._util import full_f32_matmul, pick_shards
from ..parallel.mesh import replicate

__all__ = ["exact_knn"]


def _query_block(Xd: torch.Tensor, norms: torch.Tensor, qs: int, k: int, block: int):
    """Distances and indices of the ``k`` nearest rows of ``Xd`` for its query rows ``qs : qs + block``."""
    dev = Xd.device
    n = Xd.shape[0]
    q, qn = Xd[qs : qs + block], norms[qs : qs + block]
    best_d = torch.full((q.shape[0], k), float("inf"), device=dev)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=dev)
    for ds in range(0, n, block):
        blk, blkn = Xd[ds : ds + block], norms[ds : ds + block]
        d2 = (qn[:, None] + blkn[None, :]) - 2.0 * (q @ blk.T)
        if ds == qs:
            # exact-zero self distance so the query point always ranks first
            d2.diagonal().fill_(-1.0)
        cat_d = torch.cat([best_d, d2], dim=1)
        cat_i = torch.cat([best_i, torch.arange(ds, ds + blk.shape[0], device=dev).expand_as(d2)], dim=1)
        best_d, pos = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
        best_i = torch.gather(cat_i, 1, pos)
    return best_d.clamp_min_(0.0).sqrt_(), best_i


def exact_knn(X: np.ndarray, k: int, *, block: int = 4096, device=None):
    """Exact Euclidean kNN (self included as the first neighbour).

    Returns numpy ``(distances, indices)`` of shape (n, k), float32 and
    int32; row i starts with i itself at distance 0 — the layout scanpy's
    neighbour stack expects.  ``device=None`` is the CUDA device; with a
    list of devices, query block ``b`` runs on device ``b % len(devices)``.
    """
    devices = pick_shards(device, "exact_knn")
    X = np.ascontiguousarray(np.asarray(X, dtype=np.float32))
    n, d = X.shape
    k = int(min(k, n))
    Xs = replicate(torch.from_numpy(X), devices)
    norms = replicate(torch.from_numpy((X * X).sum(axis=1)), devices)

    dists = np.empty((n, k), dtype=np.float32)
    idxs = np.empty((n, k), dtype=np.int32)
    starts = list(range(0, n, block))
    with full_f32_matmul():
        for g in range(0, len(starts), len(devices)):
            # one query block a device, all started before any is read
            group = list(zip(range(len(devices)), starts[g : g + len(devices)]))
            found = [_query_block(Xs[i], norms[i], qs, k, block) for i, qs in group]
            for (_, qs), (bd, bi) in zip(group, found):
                dists[qs : qs + bd.shape[0]] = bd.cpu().numpy()
                idxs[qs : qs + bd.shape[0]] = bi.cpu().numpy()
                profiling.count("knn_flops", 2 * bd.shape[0] * n * d)
    return dists, idxs
