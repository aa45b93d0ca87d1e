"""Leiden community detection (Traag, Waltman & van Eck 2019) (counterpart of ``infercnvpy_tpu/ops/leiden.py``).

Replaces the reference's leidenalg/igraph C++ dependency (reference:
tl/__init__.py:24-30 calls ``sc.tl.leiden``).  Quality function is
RBConfiguration (modularity with a resolution parameter), matching scanpy's
default partition type.  The graph is the (symmetric) fuzzy connectivity
matrix.

:func:`leiden` runs the native library (``native/leiden.cpp``, built at
first use; a failed build raises).  :func:`leiden_plain` is the JAX
package's Python implementation of the same three phases — queue-based local
moving, refinement within communities, aggregation — kept as the reference
the tests hold the port against.  Both are host-only: the graph is tiny next
to the expression matrix, and clustering is inherently sequential.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["leiden", "leiden_plain"]


class _Graph:
    """Undirected weighted graph in CSR form with per-node strengths."""

    def __init__(self, A: sp.csr_matrix, node_sizes: np.ndarray | None = None):
        A = A.tocsr()
        A.eliminate_zeros()
        self.indptr = A.indptr
        self.indices = A.indices
        self.weights = A.data.astype(np.float64)
        self.n = A.shape[0]
        self.strength = np.asarray(A.sum(axis=1)).ravel().astype(np.float64)
        self.selfloops = A.diagonal().astype(np.float64)
        self.total = self.strength.sum() / 2.0 + self.selfloops.sum() / 2.0
        # node_sizes carries aggregate-node multiplicity through aggregation
        self.node_sizes = node_sizes if node_sizes is not None else np.ones(self.n)

    def neighbors(self, v: int):
        sl = slice(self.indptr[v], self.indptr[v + 1])
        return self.indices[sl], self.weights[sl]


def _local_move(g: _Graph, comm: np.ndarray, resolution: float, rng: np.random.Generator) -> bool:
    """Queue-based fast local moving (Leiden phase 1). Mutates ``comm``."""
    two_m = 2.0 * g.total
    if two_m <= 0:
        return False
    comm_strength = np.zeros(comm.max() + 1 + g.n)
    np.add.at(comm_strength, comm, g.strength)

    order = rng.permutation(g.n)
    in_queue = np.ones(g.n, dtype=bool)
    queue = list(order)
    head = 0
    improved = False
    edge_to = {}

    while head < len(queue):
        v = queue[head]
        head += 1
        in_queue[v] = False
        c_old = comm[v]
        k_v = g.strength[v]

        nbrs, wts = g.neighbors(v)
        edge_to.clear()
        for u, w in zip(nbrs, wts):
            if u == v:
                continue
            cu = comm[u]
            edge_to[cu] = edge_to.get(cu, 0.0) + w

        comm_strength[c_old] -= k_v
        best_c = c_old
        base_gain = edge_to.get(c_old, 0.0) - resolution * k_v * comm_strength[c_old] / two_m
        best_gain = base_gain
        for c, e in edge_to.items():
            if c == c_old:
                continue
            gain = e - resolution * k_v * comm_strength[c] / two_m
            if gain > best_gain + 1e-12:
                best_gain = gain
                best_c = c
        comm_strength[best_c] += k_v

        if best_c != c_old:
            comm[v] = best_c
            improved = True
            for u in nbrs:
                if u != v and comm[u] != best_c and not in_queue[u]:
                    in_queue[u] = True
                    queue.append(u)
    return improved


def _refine(g: _Graph, comm: np.ndarray, resolution: float, rng: np.random.Generator) -> np.ndarray:
    """Leiden refinement: merge singletons within each community (phase 2)."""
    two_m = 2.0 * g.total
    refined = np.arange(g.n)
    ref_strength = g.strength.copy()
    ref_size = np.ones(g.n, dtype=np.int64)

    for v in rng.permutation(g.n):
        if ref_size[refined[v]] > 1 or ref_size[v] > 1:
            continue  # only singleton refined communities may merge
        c_v = comm[v]
        edge_to = {}
        nbrs, wts = g.neighbors(v)
        for u, w in zip(nbrs, wts):
            if u == v or comm[u] != c_v:
                continue
            ru = refined[u]
            edge_to[ru] = edge_to.get(ru, 0.0) + w
        if not edge_to:
            continue
        k_v = g.strength[v]
        best_r, best_gain = refined[v], 0.0
        for r, e in edge_to.items():
            if r == refined[v]:
                continue
            gain = e - resolution * k_v * ref_strength[r] / two_m
            if gain > best_gain + 1e-12:
                best_gain = gain
                best_r = r
        if best_r != refined[v]:
            ref_strength[best_r] += k_v
            ref_size[best_r] += ref_size[v]
            ref_size[refined[v]] -= 1
            refined[v] = best_r
    return refined


def _aggregate(g: _Graph, refined: np.ndarray) -> tuple[_Graph, np.ndarray]:
    labels, inverse = np.unique(refined, return_inverse=True)
    k = len(labels)
    P = sp.csr_matrix((np.ones(g.n), (inverse, np.arange(g.n))), shape=(k, g.n))
    A = sp.csr_matrix((g.weights, g.indices, g.indptr), shape=(g.n, g.n))
    A_agg = (P @ A @ P.T).tocsr()
    sizes = np.asarray(P @ g.node_sizes).ravel()
    return _Graph(A_agg, sizes), inverse


def _symmetrize(adjacency) -> sp.csr_matrix:
    A = sp.csr_matrix(adjacency)
    return (A + A.T) / 2.0  # symmetrize defensively


def leiden(adjacency: sp.spmatrix, resolution: float = 1.0, *, seed: int = 0, max_rounds: int = 20) -> np.ndarray:
    """Cluster a (symmetric, weighted) graph with the native library; int64 labels ordered by size.

    Labels are renumbered so cluster 0 is the largest — matching scanpy's
    category ordering conventions for ``cnv_leiden``.
    """
    from ..native import leiden as native_leiden

    A = _symmetrize(adjacency).tocsr()
    A.sort_indices()
    return native_leiden(A.indptr, A.indices, A.data, resolution=float(resolution), seed=int(seed),
                         max_rounds=int(max_rounds))


def leiden_plain(
    adjacency: sp.spmatrix, resolution: float = 1.0, *, seed: int = 0, max_rounds: int = 20
) -> np.ndarray:
    """The Python Leiden of the JAX package (``use_native=False`` there): the tests' reference."""
    A = _symmetrize(adjacency)
    rng = np.random.default_rng(seed)

    g = _Graph(A)
    membership = np.arange(g.n)  # node -> community on the CURRENT aggregate level
    mapping = np.arange(g.n)  # original node -> current aggregate node

    for _ in range(max_rounds):
        comm = membership.copy()
        improved = _local_move(g, comm, resolution, rng)
        n_comm = len(np.unique(comm))
        if not improved and n_comm == g.n:
            membership = comm
            break
        refined = _refine(g, comm, resolution, rng)
        g_new, inverse = _aggregate(g, refined)
        # initial partition of the aggregate graph = phase-1 communities
        agg_comm = np.zeros(g_new.n, dtype=np.int64)
        agg_comm[inverse] = comm  # refined community -> its phase-1 community
        if g_new.n == g.n:
            membership = comm
            break
        g = g_new
        membership = agg_comm
        mapping = inverse[mapping]

    final = membership[mapping]
    # renumber by decreasing cluster size
    labels, counts = np.unique(final, return_counts=True)
    order = labels[np.argsort(-counts, kind="stable")]
    remap = {old: new for new, old in enumerate(order)}
    return np.asarray([remap[x] for x in final], dtype=np.int64)
