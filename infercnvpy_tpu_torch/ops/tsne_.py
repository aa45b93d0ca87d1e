"""t-SNE on the device (counterpart of ``infercnvpy_tpu/ops/tsne_.py``).

The reference delegates to ``sc.tl.tsne`` (reference: tl/__init__.py:139).
Sparse high-dimensional affinities come from the exact kNN graph
(3·perplexity neighbours, like Barnes-Hut t-SNE) with a per-point beta
bisection over all rows at once; then full gradient descent where the O(N²)
repulsion is computed from the 2-D embedding in row tiles (``_row_block``,
as in the JAX package), never as an (n, n) matrix.

The start layout ``Y0`` is drawn exactly as the JAX package draws it, so
both start from the same points.  The beta bisection runs in float64 (the
JAX package with x64 on); the descent in float32 with its products in full
float32.  The attractive sums per point are segment sums over the
affinities' rows (no float atomics), so a rerun on the card is bit-identical.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import torch

from .._util import full_f32_matmul, pick_device
from .knn import exact_knn

__all__ = ["tsne_embed"]


def _binary_search_beta(d2: torch.Tensor, target_entropy: float) -> torch.Tensor:
    """Per-row beta (precision) s.t. the conditional distribution's perplexity matches; returns float64 P."""
    n = d2.shape[0]
    beta = torch.ones(n, dtype=torch.float64, device=d2.device)
    lo = torch.zeros_like(beta)
    hi = torch.full_like(beta, float("inf"))
    d2 = d2.double()
    for _ in range(64):
        p = torch.exp(-d2 * beta[:, None])
        sum_p = torch.clamp_min(p.sum(dim=1), 1e-12)
        H = torch.log(sum_p) + beta * (d2 * p).sum(dim=1) / sum_p
        too_high = H > target_entropy  # entropy too high -> increase beta
        new_lo = torch.where(too_high, beta, lo)
        new_hi = torch.where(too_high, hi, beta)
        beta = torch.where(
            too_high,
            torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            torch.where(lo <= 0, beta / 2.0, (beta + new_lo) / 2.0),
        )
        lo, hi = new_lo, new_hi
    p = torch.exp(-d2 * beta[:, None])
    return p / torch.clamp_min(p.sum(dim=1, keepdim=True), 1e-12)


def _row_block(n: int) -> int:
    """Row-tile size bounding the repulsion working set to ~128 MB."""
    rb = int(128e6 / (12.0 * max(n, 1)))
    return max(8, min(2048, (rb // 8) * 8, n))


def _optimize(Y, P_rows, P_cols, P_vals, n_iter, exag_iter, early_exaggeration, learning_rate, rb):
    n = Y.shape[0]
    lengths = torch.bincount(P_rows, minlength=n)  # P_rows ascend (COO of a CSR matrix)

    def grad_fn(Y, exag):
        # repulsive, over row tiles: q_ij = 1/(1+|y_i-y_j|²) via the product form of d²;
        # force_i = (Σ_j q²)·y_i − q²·Y (one skinny product), Z accumulated
        sq = (Y * Y).sum(dim=1)
        forces, zparts = [], []
        for base in range(0, n, rb):
            yb, sqb = Y[base : base + rb], sq[base : base + rb]
            d2 = sqb[:, None] + sq[None, :] - 2.0 * (yb @ Y.T)
            q = 1.0 / (1.0 + torch.clamp_min(d2, 0.0))
            q[:, base : base + yb.shape[0]].fill_diagonal_(0.0)
            q2 = q * q
            forces.append(q2.sum(dim=1)[:, None] * yb - q2 @ Y)
            zparts.append(q.sum())
        Z = torch.clamp_min(torch.stack(zparts).sum(), 1e-12)
        rep = torch.cat(forces) / Z
        # attractive: sparse over the kNN affinities, summed per row
        pd = Y[P_rows] - Y[P_cols]
        pq = 1.0 / (1.0 + (pd * pd).sum(dim=1))
        att = torch.segment_reduce((exag * P_vals * pq)[:, None] * pd, "sum", lengths=lengths, axis=0)
        return 4.0 * (att - rep)

    vel = torch.zeros_like(Y)
    gains = torch.ones_like(Y)
    for i in range(n_iter):
        exag = early_exaggeration if i < exag_iter else 1.0
        momentum = 0.5 if i < exag_iter else 0.8
        g = grad_fn(Y, exag)
        same_sign = torch.sign(g) == torch.sign(vel)
        gains = torch.clamp_min(torch.where(same_sign, gains * 0.8, gains + 0.2), 0.01)
        vel = momentum * vel - learning_rate * gains * g
        Y = Y + vel
        Y = Y - Y.sum(dim=0, keepdim=True) / n
    return Y


def tsne_embed(
    X: np.ndarray,
    *,
    perplexity: float = 30.0,
    n_components: int = 2,
    n_iter: int = 1000,
    early_exaggeration: float = 12.0,
    learning_rate: float = 200.0,
    seed: int = 0,
    max_cells: int | None = 50_000,
    device=None,
) -> np.ndarray:
    """Embed X (cells × features, usually the CNV PCA) into 2-D with t-SNE; ``device=None`` is the CUDA device.

    The repulsive term is exact O(n²) work per iteration (blocked so memory
    stays bounded); above ``max_cells`` this is declined with guidance rather
    than left to run for hours — pass ``max_cells=None`` to override.
    """
    dev = pick_device(device, "tsne_embed")
    X = np.asarray(X, dtype=np.float32)
    n = X.shape[0]
    if max_cells is not None and n > max_cells:
        raise ValueError(
            f"t-SNE on {n} cells exceeds max_cells={max_cells}: the exact O(n²) "
            "repulsion would take hours at this size. Use tl.umap (scales near-"
            "linearly), subsample, or pass max_cells=None to force it."
        )
    perplexity = min(perplexity, max(1.0, (n - 1) / 3.0))
    k = int(min(n - 1, max(3, 3 * perplexity)))

    dists, idxs = exact_knn(X, k + 1, device=dev)
    d2 = torch.from_numpy(dists[:, 1:] ** 2).to(dev)
    P_cond = _binary_search_beta(d2, math.log(perplexity)).cpu().numpy()

    rows = np.repeat(np.arange(n), k)
    cols = idxs[:, 1:].ravel()
    P = sp.coo_matrix((P_cond.ravel(), (rows, cols)), shape=(n, n)).tocsr()
    P = (P + P.T) / (2.0 * n)
    P = P.tocoo()

    # the JAX package's start: drawn for n padded to whole row tiles, first n rows used
    rng = np.random.default_rng(seed)
    rb = _row_block(n)
    n_pad = -(-n // rb) * rb
    Y0 = (rng.standard_normal((n_pad, n_components)) * 1e-4).astype(np.float32)[:n]

    with full_f32_matmul():
        Y = _optimize(
            torch.from_numpy(np.ascontiguousarray(Y0)).to(dev),
            torch.from_numpy(P.row.astype(np.int64)).to(dev),
            torch.from_numpy(P.col.astype(np.int64)).to(dev),
            torch.from_numpy(P.data.astype(np.float32)).to(dev),
            int(n_iter),
            250,
            float(early_exaggeration),
            float(learning_rate),
            rb,
        )
    return Y.cpu().numpy().astype(np.float32, copy=False)
