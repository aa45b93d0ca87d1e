"""UMAP layout optimisation on the device (counterpart of ``infercnvpy_tpu/ops/umap_.py``).

The reference delegates to ``sc.tl.umap`` (reference: tl/__init__.py:103),
which wraps umap-learn's numba SGD.  Here the embedding is optimised with the
same objective (attractive/repulsive cross-entropy on the fuzzy graph, the
standard (a, b) low-dimensional similarity curve) as a vectorised epoch loop
on the device: every edge applies its attraction with probability
proportional to its membership weight; negative samples are drawn uniformly.

Reproducible on the card: the random draws come from a ``torch.Generator``
seeded by ``seed``, and the per-node sums of the edge gradients are segment
sums over edges grouped by node once (``torch.segment_reduce``), not float
atomics, so a rerun with the same seed gives the same layout bit for bit.
The spectral initialisation starts ARPACK from a vector drawn from ``seed``
for the same reason (without one, ARPACK's own generator advances between
calls).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .. import profiling
from .._util import pick_device

__all__ = ["umap_layout", "find_ab_params", "spectral_init"]


def find_ab_params(spread: float = 1.0, min_dist: float = 0.5):
    """Fit the (a, b) similarity-curve parameters (umap-learn's procedure)."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.zeros_like(xv)
    yv[xv < min_dist] = 1.0
    mask = xv >= min_dist
    yv[mask] = np.exp(-(xv[mask] - min_dist) / spread)
    params, _ = curve_fit(curve, xv, yv)
    return float(params[0]), float(params[1])


def spectral_init(graph: sp.spmatrix, n_components: int = 2, seed: int = 0) -> np.ndarray:
    """Spectral layout from the normalised graph Laplacian (umap's default init); host scipy.

    Falls back to a uniform random layout where ARPACK does not converge or
    the graph is too small for it, as the JAX package does.
    """
    from scipy.sparse.linalg import ArpackError, ArpackNoConvergence, eigsh

    n = graph.shape[0]
    rng = np.random.default_rng(seed)
    try:
        A = sp.csr_matrix(graph)
        deg = np.asarray(A.sum(axis=1)).ravel()
        deg[deg == 0] = 1.0
        Dinv = sp.diags(1.0 / np.sqrt(deg))
        L = sp.identity(n) - Dinv @ A @ Dinv
        k = n_components + 1
        # a stream of its own, so that ``rng`` draws what the JAX package's draws
        v0 = np.random.default_rng([seed, 1]).uniform(-1.0, 1.0, size=n)
        vals, vecs = eigsh(L, k=k, which="SM", tol=1e-4, maxiter=n * 5, v0=v0)
        order = np.argsort(vals)
        emb = vecs[:, order[1:k]]
        expansion = 10.0 / max(np.abs(emb).max(), 1e-12)
        return (emb * expansion).astype(np.float32) + rng.normal(scale=1e-4, size=(n, n_components)).astype(np.float32)
    except (ArpackNoConvergence, ArpackError, ValueError, TypeError):
        return rng.uniform(-10, 10, size=(n, n_components)).astype(np.float32)


def _select_edges(graph: sp.coo_matrix, n_epochs: int):
    """The edges the epochs sample, in COO order: ``(heads, tails, probs)``.

    An edge whose weight is under 1/n_epochs of the largest would be sampled
    less than once in the run; it is dropped, as umap-learn does.
    """
    w = graph.data.astype(np.float32)
    keep = w >= w.max() / float(n_epochs)
    heads = graph.row[keep].astype(np.int32)
    tails = graph.col[keep].astype(np.int32)
    probs = (w[keep] / w.max()).astype(np.float32)
    return heads, tails, probs


def _negative_samples(gen, n: int, n_edges: int, rate: int, device) -> torch.Tensor:
    """One epoch's negative samples: ``rate`` uniform node indices for each edge."""
    return torch.randint(0, n, (n_edges, rate), generator=gen, device=device)


class _SegmentSum:
    """Deterministic per-node sums of per-edge rows: edges grouped by node once, then ``segment_reduce``."""

    def __init__(self, nodes: torch.Tensor, n: int):
        self.order = torch.argsort(nodes, stable=True)
        self.lengths = torch.bincount(nodes, minlength=n)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(values[self.order], "sum", lengths=self.lengths, axis=0)


def _optimize(emb, heads, tails, probs, a, b, gen, n_epochs, negative_sample_rate, initial_alpha):
    n = emb.shape[0]
    by_head = _SegmentSum(heads, n)
    by_tail = _SegmentSum(tails, n)
    for e in range(n_epochs):
        alpha = initial_alpha * (1.0 - e / n_epochs)

        active = (torch.rand(probs.shape, generator=gen, device=probs.device) < probs).to(emb.dtype)
        diff = emb[heads] - emb[tails]
        d2 = (diff * diff).sum(dim=1)
        # attractive gradient coefficient (umap-learn optimize_layout)
        ac = (-2.0 * a * b * d2 ** (b - 1.0)) / (a * d2**b + 1.0)
        ac = torch.where(d2 > 0, ac, torch.zeros_like(ac))
        grad = torch.clamp(ac[:, None] * diff, -4.0, 4.0) * active[:, None]
        emb = emb + by_head(alpha * grad)
        emb = emb + by_tail(-alpha * grad)

        # negative samples: repulsion on the head endpoint only
        neg = _negative_samples(gen, n, heads.shape[0], negative_sample_rate, heads.device)
        diffn = emb[heads][:, None, :] - emb[neg]
        d2n = (diffn * diffn).sum(dim=2)
        rc = (2.0 * b) / ((0.001 + d2n) * (a * d2n**b + 1.0))
        gradn = torch.clamp(rc[:, :, None] * diffn, -4.0, 4.0) * active[:, None, None]
        emb = emb + by_head(alpha * gradn.sum(dim=1))
    return emb


def umap_layout(
    graph: sp.spmatrix,
    *,
    n_components: int = 2,
    min_dist: float = 0.5,
    spread: float = 1.0,
    n_epochs: int | None = None,
    initial_alpha: float = 1.0,
    negative_sample_rate: int = 5,
    init: np.ndarray | None = None,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """Optimise a UMAP embedding of a fuzzy connectivity graph; ``device=None`` is the CUDA device."""
    dev = pick_device(device, "umap_layout")
    graph = sp.coo_matrix(graph)
    n = graph.shape[0]
    if n_epochs is None:
        n_epochs = 500 if n <= 10000 else 200

    heads, tails, probs = _select_edges(graph, n_epochs)
    a, b = find_ab_params(spread, min_dist)
    with profiling.span("umap.init", cells=n):
        emb0 = spectral_init(graph, n_components, seed) if init is None else np.asarray(init, np.float32)

    with profiling.span("umap.epochs", cells=n, epochs=int(n_epochs)):
        profiling.count("umap_edges", len(heads))
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        emb = _optimize(
            torch.from_numpy(np.ascontiguousarray(emb0)).to(dev),
            torch.from_numpy(heads.astype(np.int64)).to(dev),
            torch.from_numpy(tails.astype(np.int64)).to(dev),
            torch.from_numpy(probs).to(dev),
            a,
            b,
            gen,
            int(n_epochs),
            int(negative_sample_rate),
            float(initial_alpha),
        )
        return emb.cpu().numpy().astype(np.float32, copy=False)
