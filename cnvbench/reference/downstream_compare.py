"""The comparison that decides ``correct`` for the downstream chain against :mod:`reference.downstream`.

Stage by stage: each stage's reference takes the program's own input to that
stage, so one stage's rounding is not charged to the next.  ``X_cnv`` is the
atlas's ``tl.infercnv`` output; the program's outputs are the slots of one
chain (:class:`Output`).  Numbers compared, each ≤ its limit (:data:`LIMITS`):

* ``pca_sval_err`` — ``max_i |σ_i(program) − σ_i(reference)| / σ_1(reference)``,
  the program's σ read from ``uns["cnv_pca"]["variance"] · (n − 1)``, the
  reference's from ``X_cnv`` in float64;
* ``pca_energy_gap`` — ``(Σ σ_i²(reference) − ‖P_S X‖²_F) / Σ σ_i²(reference)``,
  the energy of ``X_cnv`` that the span of the program's scores ``S`` misses.
  ``tl.pca`` keeps no components, so this reads the scores' span where the
  description reads ``‖X V_program‖²``; the two agree when ``S = X V``
  (Ky Fan: the reading lies in [0, 1] either way), and neither asks for the
  trailing, nearly tied components' directions;
* ``pca_proj_err`` — ``max |S − X V̂| / max |S|`` with ``V̂ = XᵀS diag(σ(program))⁻²``,
  the components that ``S = X V`` implies: the projection, and the scores'
  scale against the program's own σ;
* ``knn_dist_err`` — the largest error of a row's sorted program distances
  against the float64 exact kNN of the program's scores, relative to the
  row's k-th reference distance;
* ``knn_set_miss`` — the share of rows with a program neighbour whose float64
  distance exceeds the row's k-th reference distance by more than a tie:
  ``d² > d_k² + 2⁻¹⁶ (|s_i|² + |s_j|²)``, 256 times the float32 rounding of
  the program's expanded square;
* ``conn_err`` — ``max |program − reference|`` over the union of both patterns
  of ``obsp["cnv_neighbors_connectivities"]``, the reference built from the
  program's kNN distances and indices (``obsp["cnv_neighbors_distances"]``
  with the point itself put back first);
* ``leiden_disconnected`` — communities of ``obs["cnv_leiden"]`` that their
  own edges of the program's graph do not connect;
* ``leiden_quality_short`` — ``Q(planted) − Q(program)``, RBConfiguration
  quality ÷ 2m at the chain's resolution (1) on the program's graph; the planted partition
  is the generator's clones and normal types (``obs["cell_type"]``);
* ``cnv_score_err`` — the largest relative error of ``obs["cnv_score"]``
  against each cluster's mean ``|X_cnv|`` under the program's labels;
* ``umap_lost`` — 1 − the mean share of each cell's k − 1 graph neighbours
  that are among its k − 1 nearest in the 2-D layout;
* ``umap_ce_vs_start`` — the layout's cross-entropy on the program's graph
  (``reference.layout_cross_entropy``: the objective UMAP's epochs descend,
  float64, ``a, b`` fitted for the chain's ``min_dist`` 0.5 and ``spread`` 1)
  ÷ that of the reference's spectral start on the same graph, the layout from
  which the epochs start: this holds that the epochs ran;
* ``umap_ce_vs_shuffled`` — the same cross-entropy ÷ that of the layout with
  its cells permuted within each Leiden community of the program's: this
  holds the layout inside each community, which ``umap_lost`` cannot, since
  a sound layout keeps a cell's 14 graph neighbours among its 14 nearest
  within its community at about chance (``PERF.md`` §2);
* ``umap_nonfinite`` — non-finite coordinates of ``obsm["X_cnv_umap"]``, or
  all of them where its shape is wrong.

No reference reproduces a Leiden partition or a UMAP layout: they are held by
structure and quality alone.  Each limit is set between the largest reading
of sound runs over many seeds and the smallest reading of a control or a
planted fault (``PERF.md``): the chain on ``X_cnv`` rounded through bfloat16
(fails the PCA's numbers), the JAX package's self-counting σ (fails
``conn_err``), the program's spectral start with the epochs skipped (fails
``umap_ce_vs_start``), the layout permuted within its communities or whole
(fails ``umap_ce_vs_shuffled``), and ``cnvbench/tests/``'s planted faults.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from . import downstream as ref

#: number -> limit; a reading above its limit is not correct.  Readings on an H100 (PERF.md §2): the largest of the
#: sound runs (22 on 21 seeds; the layout's cross-entropy ratios on 5), the smallest of the controls on 5 seeds
LIMITS = {
    # sound 2.0e-9 (float32 Gram); X_cnv through bfloat16 2.0e-6
    "pca_sval_err": 1e-7,
    # sound 1.8e-14; bfloat16 3.9e-7
    "pca_energy_gap": 1e-10,
    # sound 4.9e-7 (float32 projection); bfloat16 9.4e-4
    "pca_proj_err": 2e-5,
    # sound 1.6e-6 (float32 products); TF32 products move distances by ~1e-3 (ops/knn.py)
    "knn_dist_err": 1e-4,
    # sound 0: no neighbour past a tie; a tile of 4,096 query rows lost is 4 % of the atlas
    "knn_set_miss": 1e-4,
    # sound 3.0e-8, the float32 rounding of values up to 1; the self-counting sigma 0.54
    "conn_err": 1e-6,
    # Leiden's own guarantee: every community connected
    "leiden_disconnected": 0,
    # sound -0.39 to -0.31; labels shuffled read Q(planted) > 0
    "leiden_quality_short": 0.0,
    # sound 0 on the card (float64 sums), 1.1e-7 on the host (float32 sums, device="cpu"); X_cnv through bfloat16 4.4e-6
    "cnv_score_err": 1e-6,
    # sound 0.9960-0.9974 (0.26-0.40 % of graph neighbours kept); a permuted layout keeps 14 of 102,400: 0.99986
    "umap_lost": 0.999,
    # sound 0.138-0.352 (0.456 at 700 cells on the CPU); the epochs skipped, the program's spectral start, 1.0000
    "umap_ce_vs_start": 0.7,
    # sound 0.569-0.630 (0.77 at 700 cells on the CPU); the layout permuted within communities 0.9974, whole
    # 0.9999, the epochs skipped 0.851
    "umap_ce_vs_shuffled": 0.8,
    "umap_nonfinite": 0,
}
#: the tie of ``knn_set_miss``, a share of ``|s_i|² + |s_j|²``
TIE = 2.0**-16


@dataclass
class Output:
    """What one chain left in its AnnData."""

    scores: np.ndarray  # obsm["X_cnv_pca"]
    variance: np.ndarray  # uns["cnv_pca"]["variance"]
    distances: object  # obsp["cnv_neighbors_distances"], CSR, the point itself left out
    connectivities: object  # obsp["cnv_neighbors_connectivities"], CSR
    labels: np.ndarray  # obs["cnv_leiden"] as integer codes
    cnv_score: np.ndarray  # obs["cnv_score"]
    layout: np.ndarray  # obsm["X_cnv_umap"]


def output_of(adata) -> Output:
    leiden = adata.obs["cnv_leiden"]
    return Output(
        scores=np.asarray(adata.obsm["X_cnv_pca"]),
        variance=np.asarray(adata.uns["cnv_pca"]["variance"], dtype=np.float64),
        distances=adata.obsp["cnv_neighbors_distances"].tocsr(),
        connectivities=adata.obsp["cnv_neighbors_connectivities"].tocsr(),
        labels=np.unique(np.asarray(leiden).astype(str), return_inverse=True)[1].astype(np.int64),
        cnv_score=np.asarray(adata.obs["cnv_score"], dtype=np.float64),
        layout=np.asarray(adata.obsm["X_cnv_umap"]),
    )


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(repr((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def output_digest(out: Output) -> str:
    """Bytes of one chain's outputs, to compare each distinct output once."""
    return digest(out.scores, out.variance, out.distances.indptr, out.distances.indices, out.distances.data,
                  out.connectivities.indptr, out.connectivities.indices, out.connectivities.data, out.labels,
                  out.cnv_score, out.layout)


def neighbour_table(D, m: int):
    """``(distances, indices)``, (n, m), of each row of the CSR ``D`` in ascending distance; −1 / inf pad."""
    n = D.shape[0]
    counts = np.diff(D.indptr)
    dist = np.full((n, m), np.inf)
    idx = np.full((n, m), -1, dtype=np.int64)
    pos = np.arange(D.nnz) - np.repeat(D.indptr[:-1], counts)
    rows = np.repeat(np.arange(n), counts)
    ok = pos < m
    dist[rows[ok], pos[ok]] = D.data[ok]
    idx[rows[ok], pos[ok]] = D.indices[ok]
    order = np.argsort(dist, axis=1, kind="stable")
    return np.take_along_axis(dist, order, axis=1), np.take_along_axis(idx, order, axis=1)


def _coo(M, device):
    import torch

    M = M.tocoo()
    return (torch.as_tensor(M.row.astype(np.int64), device=device),
            torch.as_tensor(M.col.astype(np.int64), device=device),
            torch.as_tensor(M.data, device=device).double())


def max_diff(a, b, n: int) -> float:
    """``max |A − B|`` over the union of the patterns of two sparse matrices given as ``(rows, cols, values)``."""
    import torch

    keys = torch.cat([a[0] * n + a[1], b[0] * n + b[1]])
    if keys.numel() == 0:
        return 0.0
    uniq, inv = torch.unique(keys, return_inverse=True)
    va = torch.zeros(len(uniq), dtype=torch.float64, device=keys.device).index_add_(0, inv[: len(a[2])], a[2])
    vb = torch.zeros(len(uniq), dtype=torch.float64, device=keys.device).index_add_(0, inv[len(a[2]):], b[2])
    return float((va - vb).abs().max())


CHAIN = {"pca": {"n_comps": 50, "zero_center": False}, "neighbors": {"n_neighbors": 15},
         "leiden": {"resolution": 1.0, "random_state": 0}, "umap": {"min_dist": 0.5, "spread": 1.0}}
"""infercnvpy's defaults for the chain, by entry point: what a configuration without a ``downstream`` group runs."""


def chain_of(config: dict) -> dict:
    """The keyword arguments of each entry point of the chain: :data:`CHAIN` under the configuration's
    ``downstream`` group.  The reference is uncentred PCA only, so ``zero_center`` must stay false."""
    given = config.get("downstream", {})
    chain = {stage: {**kw, **given.get(stage, {})} for stage, kw in CHAIN.items()}
    if chain["pca"]["zero_center"]:
        raise ValueError("the reference holds the uncentred PCA only: zero_center must be false")
    return chain


class Reference:
    """The chain's reference for one ``X_cnv`` (CSR) and its planted labels; stages cached by their input.

    The chain's parameters are ``chain``'s (:func:`chain_of`; infercnvpy's defaults when
    ``None``): ``min(n_comps, min(X.shape) - 1)`` components, ``n_neighbors`` neighbours
    (the point itself among them), ``local_connectivity`` 1, ``set_op_mix_ratio`` 1,
    Leiden's resolution, UMAP's ``min_dist`` and ``spread``.
    """

    def __init__(self, X_cnv, planted, device, chain: dict | None = None):
        chain = chain_of({}) if chain is None else chain
        self.X = X_cnv.tocsr()
        self.planted = np.unique(np.asarray(planted).astype(str), return_inverse=True)[1].astype(np.int64)
        self.device = device
        self.n_comps = min(int(chain["pca"]["n_comps"]), min(self.X.shape) - 1)
        self.k = min(int(chain["neighbors"]["n_neighbors"]), self.X.shape[0])
        self.resolution = float(chain["leiden"]["resolution"])
        self.ab = ref.ab_params(spread=float(chain["umap"]["spread"]), min_dist=float(chain["umap"]["min_dist"]))
        self._pca = None
        self._cache: dict = {}

    def _cached(self, key, compute):
        if key not in self._cache:
            self._cache[key] = compute()
        return self._cache[key]

    def pca(self) -> ref.PCA:
        if self._pca is None:
            self._pca = ref.gram_pca(self.X, self.n_comps, self.device)
        return self._pca

    # -- each stage on the program's own input ---------------------------------------------------------
    def pca_readings(self, out: Output) -> dict:
        import torch

        n = self.X.shape[0]
        bad = {"pca_sval_err": float("inf"), "pca_energy_gap": 1.0, "pca_proj_err": float("inf")}
        if out.scores.shape != (n, self.n_comps) or out.variance.shape != (self.n_comps,):
            return bad
        p = self.pca()
        sig = torch.as_tensor(np.sqrt(np.maximum(out.variance, 0.0) * max(1, n - 1)), device=self.device)
        sval = float(((sig - p.sigma).abs() / p.sigma[0]).max())
        XtS = ref.project(self.X, out.scores, self.device)
        try:
            gap = (p.top_energy - ref.captured_energy(XtS, out.scores)) / p.top_energy
        except RuntimeError:  # the scores' columns are not independent
            gap = 1.0
        V = XtS / (sig * sig).clamp_min(1e-300)
        proj = ref.projection_residual(self.X, out.scores, V, self.device) / max(float(np.abs(out.scores).max()),
                                                                                1e-300)
        return {"pca_sval_err": sval, "pca_energy_gap": float(gap), "pca_proj_err": proj}

    def knn_readings(self, out: Output) -> dict:
        import torch

        m = self.k - 1
        dist_p, idx_p = neighbour_table(out.distances, m)
        key = ("knn", digest(out.scores))
        ref_d, _ = self._cached(key, lambda: ref.exact_knn(out.scores, m, self.device))
        dp = torch.as_tensor(dist_p, device=self.device)
        radius = ref_d[:, -1]
        scale = torch.where(radius > 0, radius, torch.full_like(radius, 1e-300))
        dist_err = float(((dp - ref_d).abs().max(dim=1).values / scale).max())
        S = torch.as_tensor(out.scores, device=self.device).double()
        sq = (S * S).sum(dim=1)
        idx = torch.as_tensor(idx_p, device=self.device)
        d64 = ref.pair_distances(out.scores, idx_p, self.device)
        tie = TIE * (sq[:, None] + sq[idx.clamp_min(0)])
        miss = ((d64 * d64) > (radius * radius)[:, None] + tie).any(dim=1)
        return {"knn_dist_err": dist_err, "knn_set_miss": float(miss.double().mean())}

    def connectivities(self, out: Output, count_self: bool = False):
        """The reference's connectivities from the program's kNN, as ``(rows, cols, values)``."""
        import torch

        def compute():
            n, m = out.distances.shape[0], self.k - 1
            dist_p, idx_p = neighbour_table(out.distances, m)
            dists = torch.as_tensor(np.hstack([np.zeros((n, 1)), dist_p]), device=self.device)
            idx = torch.as_tensor(np.hstack([np.arange(n)[:, None], idx_p]), device=self.device)
            rho, sigma = ref.smooth_knn_dist(dists, count_self=count_self)
            return ref.fuzzy_union(idx, ref.membership(dists, idx, rho, sigma))

        return self._cached(("conn", count_self, digest(out.distances.indptr, out.distances.indices,
                                                        out.distances.data)), compute)

    def conn_err(self, out: Output, count_self: bool = False) -> float:
        n = out.distances.shape[0]
        return max_diff(_coo(out.connectivities, self.device), self.connectivities(out, count_self), n)

    def leiden_readings(self, out: Output) -> dict:
        rows, cols, w = _coo(out.connectivities, self.device)
        q_planted = ref.rb_quality(rows, cols, w, self.planted, self.resolution)
        q_program = ref.rb_quality(rows, cols, w, out.labels, self.resolution)
        return {"leiden_disconnected": ref.disconnected_communities(rows, cols, out.labels),
                "leiden_quality_short": q_planted - q_program}

    def cnv_score_err(self, out: Output) -> float:
        import torch

        want = ref.cnv_score(self.X, out.labels, self.device)
        got = torch.as_tensor(out.cnv_score, device=self.device)
        return float(((got - want).abs() / want.abs().clamp_min(1e-300)).max())

    def layout_baseline(self, out: Output):
        """``(rows, cols, weights, negatives, the spectral start's cross-entropy)`` on the program's graph."""

        def compute():
            rows, cols, w = _coo(out.connectivities, self.device)
            n = out.connectivities.shape[0]
            negatives = ref.negative_draws(len(rows), n, self.device)
            start = ref.spectral_start(rows, cols, w, n)
            return rows, cols, w, negatives, ref.layout_cross_entropy(start, rows, cols, w, negatives, *self.ab)

        C = out.connectivities
        return self._cached(("layout", digest(C.indptr, C.indices, C.data)), compute)

    def layout_ce(self, out: Output, layout) -> dict:
        """``layout``'s cross-entropy on the program's graph ÷ the spectral start's, and ÷ its own with its cells
        permuted within the program's communities."""
        rows, cols, w, negatives, start = self.layout_baseline(out)

        def ce(L):
            return ref.layout_cross_entropy(L, rows, cols, w, negatives, *self.ab)

        here = ce(layout)
        return {"umap_ce_vs_start": here / start,
                "umap_ce_vs_shuffled": here / ce(ref.shuffle_within(layout, out.labels))}

    def umap_readings(self, out: Output) -> dict:
        n = self.X.shape[0]
        if out.layout.shape != (n, 2):
            bad = 2 * n
        else:
            bad = int((~np.isfinite(out.layout)).sum())
        if bad:
            return {"umap_lost": 1.0, "umap_ce_vs_start": float("inf"), "umap_ce_vs_shuffled": float("inf"),
                    "umap_nonfinite": bad}
        return {**self.layout_readings(out, out.layout), "umap_nonfinite": 0}

    def layout_readings(self, out: Output, layout) -> dict:
        """``umap_lost`` and the cross-entropy ratios of a finite (n, 2) ``layout`` on the program's graph."""
        _, idx_p = neighbour_table(out.distances, self.k - 1)
        return {"umap_lost": 1.0 - ref.neighbour_retention(layout, idx_p, self.device), **self.layout_ce(out, layout)}

    def compare(self, out: Output) -> dict:
        """Every reading of one chain's outputs."""
        n = self.X.shape[0]
        if out.distances.shape != (n, n) or out.connectivities.shape != (n, n) or out.labels.shape != (n,) \
                or out.cnv_score.shape != (n,):
            return {k: (float("inf") if isinstance(v, float) else n) for k, v in LIMITS.items()}
        return {**self.pca_readings(out), **self.knn_readings(out), "conn_err": self.conn_err(out),
                **self.leiden_readings(out), "cnv_score_err": self.cnv_score_err(out), **self.umap_readings(out)}


def ok(readings: dict, limits: dict = LIMITS) -> bool:
    return all(readings[k] <= limits[k] for k in limits)


def worst(readings: list) -> dict:
    return {k: max(r[k] for r in readings) for k in LIMITS} if readings else {}
