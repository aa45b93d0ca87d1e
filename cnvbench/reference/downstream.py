"""infercnvpy's downstream chain written out plainly, in float64 (reference: tl/__init__.py:13-108,
pp/__init__.py:8-43, tl/_scores.py:14-74).

infercnvpy runs scanpy on ``obsm["X_cnv"]``: ``sc.tl.pca(svd_solver="arpack",
zero_center=False)``, ``sc.pp.neighbors(n_neighbors=15)`` (umap-learn's
``fuzzy_simplicial_set`` over the kNN), ``sc.tl.leiden(resolution=1)``
(leidenalg's ``RBConfigurationVertexPartition``), its own ``cnv_score`` and
``sc.tl.umap``.  Here, each in float64 PyTorch on any device, computed in
row blocks so that the atlas fits:

* :func:`gram_pca` — the uncentred truncated SVD's singular values, from the
  top eigenvalues of the Gram ``XᵀX`` (ARPACK's answer, up to rounding), and
  :func:`project` / :func:`captured_energy` / :func:`projection_residual`,
  which hold the program's scores to them;
* :func:`exact_knn` — the exact Euclidean neighbours, the point itself left
  out (scanpy lists it first; each comparison adds it back where it needs it);
* :func:`smooth_knn_dist`, :func:`membership`, :func:`fuzzy_union` —
  umap-learn's ``smooth_knn_dist`` (ρ the ``local_connectivity``-th nonzero
  distance, interpolated; σ by bisection on the sum over the neighbours,
  column 0 left out, against ``log2(k)``, a row stopping once within 1e-5,
  at most 64 steps; the floors at 1e-3 × the mean distance),
  ``compute_membership_strengths`` and the fuzzy union
  ``mix (A + Aᵀ − A∘Aᵀ) + (1 − mix) A∘Aᵀ``;
* :func:`rb_quality` — the RBConfiguration quality of a partition, divided by
  the graph's total weight ``2m`` (leidenalg reports it undivided), and
  :func:`disconnected_communities`;
* :func:`cnv_score` — each cluster's mean ``|X_cnv|`` over its full dense
  extent, zeros counted;
* :func:`neighbour_retention` — the share of each cell's graph neighbours
  among its nearest in a layout;
* :func:`layout_cross_entropy` — the objective that UMAP's epochs descend
  (umap-learn's ``optimize_layout_euclidean`` samples it): over the graph's
  edges, weighted by their membership, ``−log q(d_ij)`` plus ``−log(1 − q)``
  of :data:`NEGATIVES` uniform negative samples a edge, ``q(d) = 1 / (1 +
  a d^{2b})`` with :func:`ab_params`; :func:`spectral_start`, umap-learn's
  spectral initialisation, the layout from which the epochs start; and
  :func:`shuffle_within`, a layout's cells permuted within each community.

Departures from the published description: umap-learn computes ρ and σ in
float32 and this module in float64; :func:`smooth_knn_dist` can also count
the point itself, as the JAX package ``infercnvpy_tpu`` does (all k columns,
64 steps with no early stop), which is the planted fault the comparison must
catch.  There is no reference of a Leiden partition or a UMAP layout: both
come from a random stream, so they are held by structure and quality alone.
:func:`layout_cross_entropy` draws its negative samples once from a seeded
stream, the same for every layout it compares, and adds umap-learn's
repulsive floor (``d² + 0.001``, from its gradient) so that points that
coincide stay finite; :func:`spectral_start` adds no noise and does not lay
the graph's disconnected components out apart, as umap-learn does.

Every product runs with TF32 off (:func:`full_precision`; float64 products
never use it, and float32 inputs are cast to float64 first).  The module
imports nothing of the program, of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np

from .infercnv import dense_rows

SMOOTH_K_TOLERANCE = 1e-5
MIN_K_DIST_SCALE = 1e-3
N_ITER = 64
BLOCK_ROWS = 8192
NEGATIVES = 5  # umap-learn's negative_sample_rate
REPULSION_FLOOR = 1e-3  # added to d² in the repulsive term, as umap-learn's gradient adds it


@contextlib.contextmanager
def full_precision():
    """TF32 off for CUDA products and convolutions inside the block; the caller's flags restored after."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _blocks(X, device, block_rows: int = BLOCK_ROWS):
    """``(lo, hi, rows)``: the CSR ``X``'s rows as dense float64 blocks on ``device``."""
    import torch

    for lo in range(0, X.shape[0], block_rows):
        hi = min(X.shape[0], lo + block_rows)
        yield lo, hi, dense_rows(X, lo, hi, device, torch.float64)


# -- PCA ------------------------------------------------------------------------------------------------
@dataclass
class PCA:
    sigma: object  # (n_comps,) float64 singular values, descending
    top_energy: float  # sum of the top n_comps squared singular values


def gram_pca(X, n_comps: int, device) -> PCA:
    """The top ``n_comps`` singular values of the CSR ``X`` (uncentred), from the eigenvalues of ``XᵀX``."""
    import torch

    d = X.shape[1]
    with full_precision():
        G = torch.zeros((d, d), dtype=torch.float64, device=device)
        for _, _, B in _blocks(X, device):
            G += B.T @ B
        evals = torch.linalg.eigvalsh(G)
    lam = torch.sort(evals, descending=True).values[:n_comps].clamp_min(0.0)
    return PCA(sigma=lam.sqrt(), top_energy=float(lam.sum()))


def project(X, S, device):
    """``XᵀS`` in float64 for the CSR ``X`` (cells × features) and the dense ``S`` (cells × comps)."""
    import torch

    S = torch.as_tensor(np.asarray(S), device=device).double()
    out = torch.zeros((X.shape[1], S.shape[1]), dtype=torch.float64, device=device)
    with full_precision():
        for lo, hi, B in _blocks(X, device):
            out += B.T @ S[lo:hi]
    return out


def captured_energy(XtS, S) -> float:
    """``‖P_S X‖²_F``: the energy of ``X`` in the span of the columns of ``S``, from ``XᵀS`` and ``S``."""
    import torch

    S = torch.as_tensor(np.asarray(S), device=XtS.device).double()
    L = torch.linalg.cholesky(S.T @ S)
    Y = torch.linalg.solve_triangular(L, XtS.T, upper=False)
    return float((Y * Y).sum())


def projection_residual(X, S, V, device) -> float:
    """``max |S − X V|`` over every entry, the CSR ``X`` in row blocks."""
    import torch

    S = torch.as_tensor(np.asarray(S), device=device).double()
    worst = 0.0
    with full_precision():
        for lo, hi, B in _blocks(X, device):
            worst = max(worst, float((S[lo:hi] - B @ V).abs().max()))
    return worst


# -- kNN ------------------------------------------------------------------------------------------------
def exact_knn(Y, k: int, device, block_rows: int = 2048):
    """The ``k`` nearest other rows of ``Y`` (float64, Euclidean): ``(distances, indices)``, (n, k) ascending.

    Candidates come from the expanded square ``|q|² + |y|² − 2 q·y``; the
    chosen neighbours' distances are then taken directly, ``‖q − y‖``.
    """
    import torch

    Y = torch.as_tensor(np.asarray(Y), device=device).double()
    n = Y.shape[0]
    norms = (Y * Y).sum(dim=1)
    dist = torch.empty((n, k), dtype=torch.float64, device=device)
    idx = torch.empty((n, k), dtype=torch.int64, device=device)
    with full_precision():
        for lo in range(0, n, block_rows):
            hi = min(n, lo + block_rows)
            d2 = norms[lo:hi, None] + norms[None, :] - 2.0 * (Y[lo:hi] @ Y.T)
            d2[torch.arange(hi - lo, device=device), torch.arange(lo, hi, device=device)] = float("inf")
            cand = torch.topk(d2, k, dim=1, largest=False).indices
            exact = (Y[lo:hi, None, :] - Y[cand]).norm(dim=2)
            order = torch.argsort(exact, dim=1, stable=True)
            dist[lo:hi] = torch.gather(exact, 1, order)
            idx[lo:hi] = torch.gather(cand, 1, order)
    return dist, idx


def pair_distances(Y, idx, device):
    """``‖y_i − y_idx[i, j]‖`` in float64 for the (n, m) neighbour table ``idx`` (−1: none, read as inf)."""
    import torch

    Y = torch.as_tensor(np.asarray(Y), device=device).double()
    idx = torch.as_tensor(np.asarray(idx), device=device).long()
    d = (Y[:, None, :] - Y[idx.clamp_min(0)]).norm(dim=2)
    return torch.where(idx >= 0, d, torch.full_like(d, float("inf")))


# -- the fuzzy graph --------------------------------------------------------------------------------------
def smooth_knn_dist(dists, local_connectivity: float = 1.0, count_self: bool = False):
    """umap-learn's ``smooth_knn_dist`` on (n, k) distances sorted ascending, the point itself in column 0.

    Returns float64 ``(rho, sigma)``.  ``count_self=True`` is the JAX
    package's rule instead: the sum over all k columns, 64 steps, no early
    stop (the planted fault).
    """
    import torch

    d = torch.as_tensor(dists).double()
    n, k = d.shape
    target = math.log2(k)
    rho = torch.zeros(n, dtype=torch.float64, device=d.device)
    index = int(math.floor(local_connectivity))
    interpolation = local_connectivity - index
    nonzero = d > 0
    n_nonzero = nonzero.sum(dim=1)
    # each row's nonzero distances first, in order
    nz = torch.sort(torch.where(nonzero, d, torch.full_like(d, float("inf"))), dim=1).values
    enough = n_nonzero >= local_connectivity
    if index > 0:
        r = nz[:, index - 1].clone()
        if interpolation > SMOOTH_K_TOLERANCE:
            has_next = n_nonzero > index
            step = torch.where(has_next, nz[:, min(index, k - 1)] - nz[:, index - 1], torch.zeros_like(r))
            r = r + interpolation * step
    else:
        r = interpolation * nz[:, 0]
    rho = torch.where(enough, r, rho)
    some = ~enough & (n_nonzero > 0)
    rho = torch.where(some, torch.where(nonzero, d, torch.zeros_like(d)).max(dim=1).values, rho)

    cols = d if count_self else d[:, 1:]
    lo = torch.zeros(n, dtype=torch.float64, device=d.device)
    hi = torch.full((n,), math.inf, dtype=torch.float64, device=d.device)
    mid = torch.ones(n, dtype=torch.float64, device=d.device)
    running = torch.ones(n, dtype=torch.bool, device=d.device)
    for _ in range(N_ITER):
        gap = cols - rho[:, None]
        psum = torch.where(gap > 0, torch.exp(-(gap / mid[:, None])), torch.ones_like(gap)).sum(dim=1)
        if not count_self:
            running &= (psum - target).abs() >= SMOOTH_K_TOLERANCE
        upper = running & (psum > target)
        lower = running & (psum <= target)
        hi = torch.where(upper, mid, hi)
        lo = torch.where(lower, mid, lo)
        bounded = torch.isfinite(hi)
        mid = torch.where(upper | (lower & bounded), (lo + hi) / 2.0, torch.where(lower, mid * 2.0, mid))
        if not bool(running.any()):
            break
    mean_row = d.mean(dim=1)
    floor = torch.where(rho > 0, MIN_K_DIST_SCALE * mean_row, MIN_K_DIST_SCALE * d.mean())
    return rho, torch.maximum(mid, floor)


def membership(dists, indices, rho, sigma):
    """``compute_membership_strengths``: (n, k) float64 weights; 0 for the point itself, 1 where d − ρ ≤ 0."""
    import torch

    d = torch.as_tensor(dists).double()
    idx = torch.as_tensor(indices, device=d.device).long()
    gap = d - rho[:, None]
    w = torch.where((gap <= 0) | (sigma[:, None] == 0), torch.ones_like(d), torch.exp(-(gap / sigma[:, None])))
    rows = torch.arange(d.shape[0], device=d.device)[:, None].expand_as(idx)
    return torch.where(idx == rows, torch.zeros_like(w), w)


def fuzzy_union(indices, weights, mix: float = 1.0):
    """The symmetric fuzzy union of the directed kNN weights: ``(rows, cols, values)``, zeros left out."""
    import torch

    idx = torch.as_tensor(indices).long()
    n, k = idx.shape
    rows = torch.arange(n, device=idx.device).repeat_interleave(k)
    cols = idx.reshape(-1)
    w = weights.reshape(-1)
    keep = cols >= 0
    rows, cols, w = rows[keep], cols[keep], w[keep]
    keys = torch.cat([rows * n + cols, cols * n + rows])
    uniq, inv = torch.unique(keys, return_inverse=True)
    a = torch.zeros(len(uniq), dtype=torch.float64, device=idx.device).index_add_(0, inv[: len(w)], w)
    t = torch.zeros(len(uniq), dtype=torch.float64, device=idx.device).index_add_(0, inv[len(w):], w)
    val = mix * (a + t - a * t) + (1.0 - mix) * a * t
    nz = val != 0
    return uniq[nz] // n, uniq[nz] % n, val[nz]


# -- Leiden's partition -------------------------------------------------------------------------------------
def rb_quality(rows, cols, weights, labels, resolution: float = 1.0) -> float:
    """RBConfiguration quality ÷ 2m of ``labels`` on the symmetric graph ``(rows, cols, weights)``:
    ``(1 / 2m) Σ_c (Σ_{i,j ∈ c} A_ij − γ K_c² / 2m)``, ``K_c`` the summed degree of community ``c``."""
    import torch

    labels = torch.as_tensor(labels, device=rows.device).long()
    w = weights.double()
    two_m = float(w.sum())
    degree = torch.zeros(len(labels), dtype=torch.float64, device=rows.device).index_add_(0, rows, w)
    n_comm = int(labels.max()) + 1
    K = torch.zeros(n_comm, dtype=torch.float64, device=rows.device).index_add_(0, labels, degree)
    inside = float(w[labels[rows] == labels[cols]].sum())
    return (inside - resolution * float((K * K).sum()) / two_m) / two_m


def disconnected_communities(rows, cols, labels) -> int:
    """Communities of ``labels`` that their own edges of the graph ``(rows, cols)`` do not connect."""
    import torch

    labels = torch.as_tensor(labels, device=rows.device).long()
    n = len(labels)
    inside = labels[rows] == labels[cols]
    r, c = rows[inside], cols[inside]
    r, c = torch.cat([r, c]), torch.cat([c, r])
    comp = torch.arange(n, device=rows.device)
    while True:  # each node takes the least label among itself and its neighbours, then jumps to that label's
        nxt = comp.scatter_reduce(0, r, comp[c], reduce="amin", include_self=True)
        nxt = nxt[nxt]
        if torch.equal(nxt, comp):
            break
        comp = nxt
    pairs = torch.unique(labels * n + comp)
    parts = torch.bincount(pairs // n, minlength=int(labels.max()) + 1)
    return int((parts > 1).sum())


# -- scores and layout ------------------------------------------------------------------------------------------
def cnv_score(X, labels, device):
    """Per cell, its cluster's mean ``|X|`` over the cluster's full dense extent (zeros count); float64."""
    import torch

    labels = torch.as_tensor(np.asarray(labels), device=device).long()
    counts = torch.as_tensor(np.diff(X.indptr), device=device)
    row = torch.arange(X.shape[0], device=device).repeat_interleave(counts)
    vals = torch.as_tensor(X.data, device=device).double().abs()
    row_abs = torch.zeros(X.shape[0], dtype=torch.float64, device=device).index_add_(0, row, vals)
    n_comm = int(labels.max()) + 1
    sums = torch.zeros(n_comm, dtype=torch.float64, device=device).index_add_(0, labels, row_abs)
    sizes = torch.bincount(labels, minlength=n_comm).double()
    return (sums / (sizes * X.shape[1]))[labels]


def neighbour_retention(layout, neighbours, device) -> float:
    """The mean over cells of the share of its graph neighbours (``neighbours``, (n, m), −1: none) that are
    among its ``m`` nearest other cells in ``layout``."""
    import torch

    nb = torch.as_tensor(np.asarray(neighbours), device=device).long()
    m = nb.shape[1]
    _, near = exact_knn(layout, m, device)
    hit = (nb[:, :, None] == near[:, None, :]).any(dim=2) & (nb >= 0)
    have = (nb >= 0).sum(dim=1).clamp_min(1)
    return float((hit.sum(dim=1) / have).mean())


def ab_params(spread: float = 1.0, min_dist: float = 0.5) -> tuple[float, float]:
    """umap-learn's ``find_ab_params``: ``a, b`` of ``1 / (1 + a d^{2b})`` fitted by least squares to 1 below
    ``min_dist`` and ``exp(−(d − min_dist) / spread)`` above it, on 300 points of ``[0, 3 spread]``."""
    from scipy.optimize import curve_fit

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2 * b)), xv, yv)
    return float(a), float(b)


def spectral_start(rows, cols, weights, n: int, seed: int = 0) -> np.ndarray:
    """umap-learn's spectral initialisation of a 2-D layout of the symmetric graph ``(rows, cols, weights)``:
    the eigenvectors of the 2nd and 3rd smallest eigenvalues of ``I − D^{-1/2} A D^{-1/2}`` (ARPACK, ``tol``
    1e-4, started from ones), scaled so that the largest ``|coordinate|`` is 10; float64 (n, 2).  Where ARPACK
    fails, uniform on ``[−10, 10]²`` from ``seed``, as umap-learn falls back to a random layout."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import ArpackError, ArpackNoConvergence, eigsh

    A = sp.csr_matrix((weights.double().cpu().numpy(), (rows.cpu().numpy(), cols.cpu().numpy())), shape=(n, n))
    deg = np.asarray(A.sum(axis=1)).ravel()
    deg[deg == 0] = 1.0
    Dinv = sp.diags(1.0 / np.sqrt(deg))
    L = sp.identity(n) - Dinv @ A @ Dinv
    try:
        vals, vecs = eigsh(L, k=3, which="SM", tol=1e-4, v0=np.ones(n), maxiter=n * 5)
    except (ArpackNoConvergence, ArpackError, ValueError, TypeError):
        return np.random.default_rng(seed).uniform(-10.0, 10.0, size=(n, 2))
    emb = vecs[:, np.argsort(vals)[1:3]]
    return emb * (10.0 / max(float(np.abs(emb).max()), 1e-300))


def negative_draws(n_edges: int, n: int, device, rate: int = NEGATIVES, seed: int = 0):
    """``rate`` uniform cells for each edge, (n_edges, rate), from a CPU stream seeded with ``seed``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, n, (n_edges, rate), generator=gen).to(device)


def layout_cross_entropy(layout, rows, cols, weights, negatives, a: float, b: float) -> float:
    """UMAP's objective of ``layout`` on the graph ``(rows, cols, weights)``, per unit of edge weight, float64:
    ``Σ w_ij [−log q_ij + Σ_s −log(1 − q_is)] / Σ w_ij``, ``s`` over each edge's row of ``negatives``, ``q = 1 /
    (1 + a d^{2b})``, :data:`REPULSION_FLOOR` added to ``d²`` in the repulsive term."""
    import torch

    Y = torch.as_tensor(np.asarray(layout), device=rows.device).double()
    w = weights.double()

    def ad2b(i, j, floor=0.0):
        d2 = ((Y[i] - Y[j]) ** 2).sum(dim=-1) + floor
        return a * d2.pow(b)

    attract = torch.log1p(ad2b(rows, cols))  # −log q
    repel = torch.log1p(1.0 / ad2b(rows[:, None], negatives, REPULSION_FLOOR)).sum(dim=1)  # −log(1 − q)
    return float((w * (attract + repel)).sum() / w.sum())


def shuffle_within(layout, labels, seed: int = 0) -> np.ndarray:
    """``layout`` with its rows permuted within each community of ``labels`` (a stream seeded with ``seed``)."""
    layout, labels = np.asarray(layout), np.asarray(labels)
    rng = np.random.default_rng(seed)
    out = layout.copy()
    order = np.argsort(labels, kind="stable")
    bounds = np.flatnonzero(np.diff(labels[order])) + 1
    for members in np.split(order, bounds):
        out[members] = layout[rng.permutation(members)]
    return out
