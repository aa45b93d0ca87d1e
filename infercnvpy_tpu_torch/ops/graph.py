"""UMAP-style fuzzy kNN connectivity graph (counterpart of ``infercnvpy_tpu/ops/graph.py``).

Replaces scanpy's ``sc.pp.neighbors`` graph construction (reference:
pp/__init__.py:43), which uses umap-learn's ``smooth_knn_dist`` /
``fuzzy_simplicial_set``, and follows umap-learn's rule:

* ``rho`` is the ``local_connectivity``-th nonzero distance of a row,
  interpolated;
* ``sigma`` is a bisection per row on ``sum_j exp(-max(d_ij - rho_i, 0) / sigma_i)``
  over the columns 1 … k−1 (column 0 is the point itself) against the target
  ``log2(k)``; a row stops as soon as ``|sum - log2(k)| < 1e-5``, after at
  most 64 steps, and is floored at ``1e-3 ×`` the row's mean distance (the
  global mean where ``rho`` is 0);
* the membership is 0 for the point itself and 1 where ``d - rho <= 0``;
  the fuzzy union is ``A + Aᵀ − A∘Aᵀ``.

The JAX package differs in its sum: it counts the self column too and runs
all 64 steps (``infercnvpy_tpu/ops/graph.py:52-66``), which moves a
connectivity by up to ~0.5; the port does not copy that.  The bisection runs
over all rows at once on the device, each row frozen once it has converged;
the fuzzy union is a scipy product on the host.

Precision: distances in float32 as the kNN returns them; ``rho``, the
bisection, the floors' means and the memberships in float64.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import torch

from .._util import pick_device

__all__ = ["fuzzy_connectivities", "knn_distance_matrix"]

_SMOOTH_K_TOLERANCE = 1e-5
_MIN_K_DIST_SCALE = 1e-3


def _smooth_knn_dist(dists: torch.Tensor, local_connectivity: float, n_iter: int = 64):
    """Per-row (rho, sigma), umap-learn's ``smooth_knn_dist``, both float64.

    dists: (n, k) float32, sorted ascending, first column = self (0).
    """
    n, k = dists.shape
    target = math.log2(float(k))
    d64 = dists.double()

    nonzero = d64 > 0.0
    n_nonzero = nonzero.sum(dim=1)
    # rho = interpolated local_connectivity-th smallest nonzero distance; a row with fewer nonzero
    # distances takes its largest, a row with none 0
    inf = torch.tensor(float("inf"), dtype=d64.dtype, device=d64.device)
    sorted_nz = torch.sort(torch.where(nonzero, d64, inf), dim=1).values
    li = int(math.floor(local_connectivity))
    interp = local_connectivity - li
    if li > 0:
        at_li = sorted_nz[:, min(li - 1, k - 1)]
        if interp > _SMOOTH_K_TOLERANCE:
            at_li = at_li + interp * (sorted_nz[:, min(li, k - 1)] - at_li)
    else:
        at_li = interp * sorted_nz[:, 0]
    row_max = torch.where(nonzero, d64, -inf).max(dim=1).values
    rho = torch.where(n_nonzero >= local_connectivity, at_li,
                      torch.where(n_nonzero > 0, row_max, torch.zeros_like(row_max)))

    # the bisection over the neighbours, column 0 (the point itself) left out
    d = torch.clamp_min(d64[:, 1:] - rho[:, None], 0.0)
    lo = torch.zeros(n, dtype=torch.float64, device=dists.device)
    hi = torch.full((n,), float("inf"), dtype=torch.float64, device=dists.device)
    mid = torch.ones(n, dtype=torch.float64, device=dists.device)
    done = torch.zeros(n, dtype=torch.bool, device=dists.device)
    for _ in range(n_iter):
        psum = torch.exp(-d / mid[:, None]).sum(dim=1)
        done |= (psum - target).abs() < _SMOOTH_K_TOLERANCE
        if bool(done.all()):
            break
        too_big = psum > target
        new_mid = torch.where(too_big, (lo + mid) / 2.0, torch.where(torch.isinf(hi), mid * 2.0, (mid + hi) / 2.0))
        hi = torch.where(done | ~too_big, hi, mid)
        lo = torch.where(done | too_big, lo, mid)
        mid = torch.where(done, mid, new_mid)
    sigma = mid

    # the floors' means in float64: a float32 mean's last bit depends on the device's summation order,
    # and memberships far out in the tail (exp(-30) and below) magnify it past 1e-5 relative
    sigma = torch.where(
        rho > 0.0,
        torch.maximum(sigma, _MIN_K_DIST_SCALE * d64.mean(dim=1)),
        torch.maximum(sigma, (_MIN_K_DIST_SCALE * d64.mean()).expand_as(sigma)),
    )
    return rho, sigma


def _membership(dists: torch.Tensor, rho: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    w = torch.exp(-torch.clamp_min(dists.double() - rho[:, None], 0.0) / sigma[:, None])
    # self column (distance 0 at position 0) gets weight 0, like umap-learn
    w[:, 0] = 0.0
    return w


def fuzzy_connectivities(
    knn_dists: np.ndarray,
    knn_indices: np.ndarray,
    *,
    local_connectivity: float = 1.0,
    set_op_mix_ratio: float = 1.0,
    device=None,
) -> sp.csr_matrix:
    """Symmetrised fuzzy-union connectivity matrix (umap fuzzy_simplicial_set); ``device=None`` is the CUDA device."""
    dev = pick_device(device, "fuzzy_connectivities")
    n, k = knn_dists.shape
    dd = torch.from_numpy(np.ascontiguousarray(knn_dists, dtype=np.float32)).to(dev)
    rho, sigma = _smooth_knn_dist(dd, float(local_connectivity))
    w = _membership(dd, rho, sigma).cpu().numpy()

    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = knn_indices.astype(np.int64).ravel()
    vals = w.ravel()
    keep = cols >= 0
    A = sp.coo_matrix((vals[keep], (rows[keep], cols[keep])), shape=(n, n)).tocsr()
    A.sum_duplicates()

    T = A.T.tocsr()
    prod = A.multiply(T)
    conn = set_op_mix_ratio * (A + T - prod) + (1.0 - set_op_mix_ratio) * prod
    conn = conn.tocsr()
    conn.eliminate_zeros()
    return conn.astype(np.float32)


def knn_distance_matrix(knn_dists: np.ndarray, knn_indices: np.ndarray) -> sp.csr_matrix:
    """Sparse kNN distance matrix, self excluded (scanpy's ``*_distances``); host only."""
    n, k = knn_dists.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), k - 1)
    cols = knn_indices[:, 1:].astype(np.int64).ravel()
    vals = knn_dists[:, 1:].astype(np.float64).ravel()
    keep = cols >= 0
    D = sp.csr_matrix((vals[keep], (rows[keep], cols[keep])), shape=(n, n))
    return D.astype(np.float32)
