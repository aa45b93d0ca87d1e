"""The port's downstream analysis against ``infercnvpy_tpu`` on the same numpy inputs.

PCA (``ops.linalg``), kNN (``ops.knn``), the fuzzy graph (``ops.graph``),
UMAP (``ops.umap_``), t-SNE (``ops.tsne_``), the ``tl`` / ``pp`` entry
points, and the whole workflow after ``tl.infercnv``.  JAX runs on the CPU
with x64 on (``tests/conftest.py``); the port with ``device="cpu"``.  Each
tolerance is stated where it is used:

* ``truncated_svd(high_precision=True)`` vs the JAX float64 path: rtol 1e-9;
  the float32 paths: rtol 1e-4 (``tests/test_downstream_differential.py:47``);
* kNN: sorted distances at atol 1e-5; neighbour sets equal on every row whose
  k-th and (k+1)-th distances are not tied (tied neighbours may come in
  another order than ``lax.top_k``'s);
* connectivities from the same kNN arrays: held against the plain reference
  (``cnvbench/reference/downstream.py``, umap-learn's rule), same pattern,
  values within one float32 ulp; the JAX package's graph differs by design;
* UMAP: ``find_ab_params`` and the sampled edges exactly equal; the epochs
  from the same start with the random draws pinned (float32 at rtol 1e-4
  after one epoch, float64 at 1e-9 after one and 1e-6 after five; the
  streams themselves differ: ``torch.Generator`` against ``jax.random``);
  the spectral start up to sign at atol 1e-2, its fallback exactly;
* t-SNE: affinities at rtol 1e-5; the layout from the same start at rtol
  1e-4 where float32 rounding does not grow (1 iteration; 20 at a low
  learning rate), the geometry where it does (20 at the default);
* the quality floors of ``tests/test_downstream.py``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import infercnvpy_tpu as cnv  # noqa: E402
import infercnvpy_tpu.ops.tsne_ as jtsne  # noqa: E402
import infercnvpy_tpu.ops.umap_ as jumap  # noqa: E402
import infercnvpy_tpu_torch as tcnv  # noqa: E402
import infercnvpy_tpu_torch.ops.tsne_ as ttsne  # noqa: E402
import infercnvpy_tpu_torch.ops.umap_ as tumap  # noqa: E402
from infercnvpy_tpu.ops.graph import fuzzy_connectivities as j_fuzzy  # noqa: E402
from infercnvpy_tpu.ops.graph import knn_distance_matrix as j_distmat  # noqa: E402
from infercnvpy_tpu.ops.knn import exact_knn as j_knn  # noqa: E402
from infercnvpy_tpu.ops.linalg import truncated_svd as j_svd  # noqa: E402
from infercnvpy_tpu_torch.ops.graph import fuzzy_connectivities as t_fuzzy  # noqa: E402
from infercnvpy_tpu_torch.ops.graph import knn_distance_matrix as t_distmat  # noqa: E402
from infercnvpy_tpu_torch.ops.knn import exact_knn as t_knn  # noqa: E402
from infercnvpy_tpu_torch.ops.linalg import truncated_svd as t_svd  # noqa: E402

CPU = "cpu"
CATS = ["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def blobs():
    """3 well-separated Gaussian blobs in 20 dims (``tests/test_downstream.py``)."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=20, size=(3, 20))
    X = np.vstack([centers[i] + rng.normal(size=(50, 20)) for i in range(3)]).astype(np.float32)
    return X, np.repeat(np.arange(3), 50)


def _spectrum_matrix(n=500, d=120, seed=0):
    """Rows with well-separated singular values (no near-degenerate top components)."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(n, d)))
    v, _ = np.linalg.qr(rng.normal(size=(d, d)))
    svals = np.geomspace(200.0, 1.0, d)
    return ((u * svals) @ v.T + 3.0).astype(np.float32)


_SVD_CASES = {
    "dense": dict(),
    "csr": dict(sparse=True),
    "multi_block": dict(block_rows=64),
    "csr_multi_block": dict(sparse=True, block_rows=96),
    "zero_center": dict(zero_center=True),
    "zero_center_multi_block": dict(zero_center=True, block_rows=128),
}


def _svd_inputs(case):
    kw = dict(_SVD_CASES[case])
    X = _spectrum_matrix()
    if kw.pop("sparse", False):
        X = X * (np.random.default_rng(1).random(X.shape) < 0.3)
        X = sp.csr_matrix(X.astype(np.float32))
    return X, kw


@pytest.mark.parametrize("case", sorted(_SVD_CASES))
def test_truncated_svd_f64_matches_jax(case):
    """high_precision=True vs the JAX float64 path: singular values and signed scores at rtol 1e-9."""
    X, kw = _svd_inputs(case)
    js, jc, jv = j_svd(X, 20, high_precision=True, **kw)
    ts, tc, tv = t_svd(X, 20, high_precision=True, device=CPU, **kw)
    assert ts.dtype == tc.dtype == np.float64
    npt.assert_allclose(tv, jv, rtol=1e-9)
    npt.assert_allclose(ts, js, rtol=1e-9, atol=1e-9 * float(jv[0]))
    npt.assert_allclose(tc, jc, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", sorted(_SVD_CASES))
def test_truncated_svd_f32_matches_jax(case):
    """The float32 paths: singular values at rtol 1e-4, scores at rtol 1e-4 (atol 1e-4 × σ₁)."""
    X, kw = _svd_inputs(case)
    js, jc, jv = j_svd(X, 20, high_precision=False, **kw)
    ts, tc, tv = t_svd(X, 20, device=CPU, **kw)
    assert ts.dtype == tc.dtype == np.float32
    npt.assert_allclose(tv, jv, rtol=1e-4)
    npt.assert_allclose(ts, js, rtol=1e-4, atol=1e-4 * float(jv[0]))


def test_truncated_svd_high_precision_ill_conditioned():
    """All 50 components of a matrix with σ spanning 1e4 at rtol 1e-6 in float64; float32 fails there."""
    rng = np.random.default_rng(3)
    u, _ = np.linalg.qr(rng.normal(size=(300, 50)))
    v, _ = np.linalg.qr(rng.normal(size=(50, 50)))
    svals_true = np.logspace(4, 0, 50)
    X = (u * svals_true) @ v.T
    scores, comps, svals = t_svd(X, 50, high_precision=True, device=CPU)
    npt.assert_allclose(svals, svals_true, rtol=1e-6)
    npt.assert_allclose(scores, X @ comps.T, rtol=1e-4, atol=float(svals_true[0]) * 1e-6)
    _, _, svals_f32 = t_svd(X, 50, device=CPU)
    assert not np.allclose(svals_f32, svals_true, rtol=1e-6)


def _tied_rows(X, k):
    """Rows whose k-th and (k+1)-th smallest exact distances lie within 1e-5 of each other."""
    X64 = X.astype(np.float64)
    D = np.sqrt(np.maximum(((X64[:, None, :] - X64[None, :, :]) ** 2).sum(-1), 0.0))
    srt = np.sort(D, axis=1)
    if k >= X.shape[0]:
        return np.zeros(X.shape[0], bool)
    return np.abs(srt[:, k] - srt[:, k - 1]) <= 1e-5


def _knn_inputs(case):
    rng = np.random.default_rng(7)
    if case == "gaussian":
        return rng.normal(size=(300, 12)).astype(np.float32), 10, 64
    if case == "duplicated_rows":
        # a gated CNV matrix: many identical (all-zero) rows and pairs of equal rows
        X = rng.normal(size=(260, 16)).astype(np.float32)
        X[:70] = 0.0
        X[200:230] = X[100:130]
        return X, 15, 64
    if case == "one_block":
        return rng.normal(size=(150, 30)).astype(np.float32), 15, 4096
    if case == "k_equals_n":
        return rng.normal(size=(12, 5)).astype(np.float32), 20, 4
    raise ValueError(case)


@pytest.mark.parametrize("case", ["gaussian", "duplicated_rows", "one_block", "k_equals_n"])
def test_exact_knn_matches_jax(case):
    X, k, block = _knn_inputs(case)
    jd, ji = j_knn(X, k, block=block)
    td, ti = t_knn(X, k, block=block, device=CPU)
    assert td.shape == jd.shape and ti.dtype == np.int32 and td.dtype == np.float32
    # self first, even among duplicates
    npt.assert_array_equal(ti[:, 0], np.arange(len(X)))
    npt.assert_array_equal(td[:, 0], 0.0)
    npt.assert_allclose(np.sort(td, axis=1), np.sort(jd, axis=1), atol=1e-5)
    tied = _tied_rows(X, ti.shape[1])
    for i in np.flatnonzero(~tied):
        assert set(ti[i]) == set(ji[i]), i
    if case == "duplicated_rows":
        assert tied.sum() >= 70  # the tie rule was exercised


@pytest.mark.parametrize("local_connectivity,set_op_mix_ratio", [(1.0, 1.0), (1.5, 1.0), (1.0, 0.5), (2.0, 0.25)])
@pytest.mark.parametrize("case", ["gaussian", "duplicated_rows"])
def test_graph_matches_jax_from_the_same_knn(case, local_connectivity, set_op_mix_ratio):
    """Fed the JAX kNN arrays: the plain reference's graph (umap-learn's rule, float64), its pattern, and its
    values at float32 rounding; the distance matrix equals the JAX package's.

    The JAX package counts the point itself in the sigma search and the port
    does not (``ROADMAP.md`` A, defect 5), so the graphs are held against the
    plain reference ``cnvbench/reference/downstream.py`` and not against each
    other.  The port's bisection and the reference's make the same float64
    steps from the same float32 distances, so each value is the reference's
    rounded to float32 (to 0 below float32's range): within one float32 ulp.  ``duplicated_rows`` has rows
    with fewer nonzero distances than ``local_connectivity``.
    """
    from cnvbench.reference import downstream as ref

    X, k, block = _knn_inputs(case)
    jd, ji = j_knn(X, k, block=block)
    kw = dict(local_connectivity=local_connectivity, set_op_mix_ratio=set_op_mix_ratio)
    got = t_fuzzy(jd, ji, device=CPU, **kw)
    d64 = torch.from_numpy(np.asarray(jd, np.float64))
    idx = torch.from_numpy(np.asarray(ji, np.int64))
    rho, sigma = ref.smooth_knn_dist(d64, local_connectivity)
    rows, cols, vals = ref.fuzzy_union(idx, ref.membership(d64, idx, rho, sigma), set_op_mix_ratio)
    want = sp.csr_matrix((vals.numpy(), (rows.numpy(), cols.numpy())), shape=got.shape)
    assert got.dtype == np.float32
    npt.assert_array_equal(got.indptr, want.indptr)
    npt.assert_array_equal(got.indices, want.indices)
    npt.assert_allclose(got.data, want.data.astype(np.float32), rtol=2.0**-23, atol=0)
    assert abs(got - got.T).max() < 1e-6
    if case == "duplicated_rows":
        assert (np.count_nonzero(np.asarray(jd) > 0, axis=1) < local_connectivity).any()
    dw, dg = j_distmat(jd, ji), t_distmat(jd, ji)
    npt.assert_array_equal(dg.indptr, dw.indptr)
    npt.assert_array_equal(dg.indices, dw.indices)
    npt.assert_array_equal(dg.data, dw.data)


def _blob_separation(emb, labels):
    """Mean inter-centroid distance / mean within-blob spread (``tests/test_downstream.py``)."""
    cents = np.vstack([emb[labels == i].mean(0) for i in range(3)])
    inter = np.linalg.norm(cents[:, None] - cents[None, :], axis=-1).sum() / 6
    intra = np.mean([np.linalg.norm(emb[labels == i] - cents[i], axis=1).mean() for i in range(3)])
    return inter / intra


@pytest.mark.parametrize("spread,min_dist", [(1.0, 0.5), (1.0, 0.1), (2.0, 0.3)])
def test_find_ab_params_equal(spread, min_dist):
    assert tumap.find_ab_params(spread, min_dist) == jumap.find_ab_params(spread, min_dist)


def _capture(module, monkeypatch):
    """Replace ``module._optimize`` by a recorder that returns its start layout."""
    seen = {}

    def fake(*args, **kwargs):
        seen["args"] = args
        return args[0]

    monkeypatch.setattr(module, "_optimize", fake)
    return seen


@pytest.mark.parametrize("n_epochs", [None, 20, 500])
def test_umap_edge_selection_equals_jax(blobs, monkeypatch, n_epochs):
    X, _ = blobs
    jd, ji = j_knn(X, 15)
    conn = j_fuzzy(jd, ji)
    jseen = _capture(jumap, monkeypatch)
    jumap.umap_layout(conn, n_epochs=n_epochs)
    _, heads, tails, probs = (np.asarray(a) for a in jseen["args"][:4])
    th, tt, tp = tumap._select_edges(sp.coo_matrix(conn), n_epochs or 500)
    npt.assert_array_equal(th, heads)
    npt.assert_array_equal(tt, tails)
    npt.assert_array_equal(tp, probs)
    tseen = _capture(tumap, monkeypatch)
    tumap.umap_layout(conn, n_epochs=n_epochs, device=CPU)
    npt.assert_array_equal(tseen["args"][1].numpy(), heads)
    npt.assert_array_equal(tseen["args"][2].numpy(), tails)
    npt.assert_array_equal(tseen["args"][3].numpy(), probs)


def test_spectral_init_is_reproducible(blobs):
    """The seed fixes ARPACK's start vector, so two calls in one process agree bit for bit."""
    X, _ = blobs
    conn = t_fuzzy(*t_knn(X, 15, device=CPU), device=CPU)
    a, b = tumap.spectral_init(conn, 2, seed=3), tumap.spectral_init(conn, 2, seed=3)
    npt.assert_array_equal(a, b)
    assert a.shape == (150, 2) and np.abs(a).max() > 1.0


def test_umap_separates_blobs_and_reruns_bit_identical(blobs):
    X, labels = blobs
    conn = t_fuzzy(*t_knn(X, 15, device=CPU), device=CPU)
    emb = tumap.umap_layout(conn, n_epochs=150, seed=0, device=CPU)
    assert emb.shape == (150, 2) and emb.dtype == np.float32
    assert np.isfinite(emb).all()
    assert _blob_separation(emb, labels) > 2.0
    npt.assert_array_equal(tumap.umap_layout(conn, n_epochs=150, seed=0, device=CPU), emb)


def _fixed_draws(negs):
    """A stand-in for one epoch's negative-sample draw that returns ``negs[0]``, ``negs[1]``, ... in turn."""
    calls = iter(range(len(negs)))
    return lambda *args, **kwargs: negs[next(calls)]


@pytest.mark.parametrize("dtype,n_epochs,tol", [("float32", 1, 1e-4), ("float64", 1, 1e-9), ("float64", 5, 1e-6)])
@pytest.mark.parametrize("case", ["attraction", "masked_edges", "repulsion"])
def test_umap_epochs_match_jax(blobs, monkeypatch, case, dtype, n_epochs, tol):
    """The epoch loop against the JAX package's from the same start, with the random draws pinned.

    Every edge of probability 1 is active on both sides and every edge of
    probability 0 inactive, so ``probs`` in {0, 1} fixes the attraction; the
    repulsion case hands both sides the same negative samples for each epoch.
    The sums run in another order, and from a random start the clipped steps
    grow that rounding about tenfold an epoch: float32 is held after one
    epoch, float64 after one and five, at rtol ``tol`` and atol ``tol`` x the
    layout's extent.  A misplaced update differs at the layout's own scale.
    """
    import jax
    import jax.numpy as jnp

    X, _ = blobs
    coo = sp.coo_matrix(j_fuzzy(*j_knn(X, 15)))
    heads, tails, _ = tumap._select_edges(coo, 200)
    rng = np.random.default_rng(1)
    probs = np.ones(len(heads), np.float32)
    if case != "attraction":
        probs[rng.random(len(heads)) < 0.4] = 0.0
    rate = 3 if case == "repulsion" else 0
    negs = rng.integers(0, X.shape[0], size=(n_epochs, len(heads), rate))
    emb0 = rng.uniform(-10, 10, size=(X.shape[0], 2)).astype(dtype)
    a, b = tumap.find_ab_params()

    monkeypatch.setattr(jax.random, "randint", _fixed_draws([jnp.asarray(n, jnp.int32) for n in negs]))
    with jax.disable_jit():
        want = np.asarray(jumap._optimize(jnp.asarray(emb0), jnp.asarray(heads), jnp.asarray(tails),
                                          jnp.asarray(probs), a, b, jax.random.PRNGKey(0), n_epochs, rate, 1.0))
    monkeypatch.setattr(tumap, "_negative_samples", _fixed_draws([torch.from_numpy(n) for n in negs]))
    got = tumap._optimize(torch.from_numpy(emb0), torch.from_numpy(heads.astype(np.int64)),
                          torch.from_numpy(tails.astype(np.int64)), torch.from_numpy(probs), a, b,
                          torch.Generator().manual_seed(0), n_epochs, rate, 1.0).numpy()
    assert want.dtype == got.dtype == dtype
    assert np.abs(want - emb0).max() > 1e-2  # the epochs moved the layout
    npt.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


def _strip(n=240, seed=0):
    """kNN connectivities of points on a 3 x 1 strip: one component, distinct low Laplacian eigenvalues."""
    rng = np.random.default_rng(seed)
    X = (rng.uniform(size=(n, 2)) * [3.0, 1.0]).astype(np.float32)
    return j_fuzzy(*j_knn(X, 15))


def test_spectral_init_matches_jax():
    """The spectral layout equals the JAX package's up to each axis's sign: ARPACK at tol 1e-4 from
    another start vector, so at atol 1e-2 on a layout of extent 10; the 1e-4 noise is the same draw."""
    conn = _strip()
    want, got = jumap.spectral_init(conn, 2, seed=5), tumap.spectral_init(conn, 2, seed=5)
    sign = np.sign(np.sum(want * got, axis=0))
    npt.assert_allclose(got * sign, want, atol=1e-2)
    assert np.abs(want).max() > 9.0


@pytest.mark.parametrize("n", [2, 3])
def test_spectral_init_fallback_equals_jax(n):
    """A graph too small for ARPACK falls back to the same uniform layout as the JAX package's."""
    conn = sp.csr_matrix(np.ones((n, n)) - np.eye(n))
    got = tumap.spectral_init(conn, 2, seed=7)
    npt.assert_array_equal(got, np.random.default_rng(7).uniform(-10, 10, size=(n, 2)).astype(np.float32))
    npt.assert_array_equal(got, jumap.spectral_init(conn, 2, seed=7))


def test_segment_sum_equals_index_add():
    """The deterministic per-node sums equal ``index_add_`` (exact in float64)."""
    rng = np.random.default_rng(0)
    nodes = torch.from_numpy(rng.integers(0, 50, 400))
    vals = torch.from_numpy(rng.normal(size=(400, 2)))
    want = torch.zeros(60, 2, dtype=torch.float64).index_add_(0, nodes, vals)
    got = tumap._SegmentSum(nodes, 60)(vals)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("perplexity", [5.0, 10.0, 15.0])
def test_tsne_affinities_and_start_equal_jax(blobs, monkeypatch, perplexity):
    """P (rows, cols, values) against the JAX package at rtol 1e-5; the same Y0.

    3·perplexity neighbours stay inside a blob here: further out, near-equal
    distances to the other blobs can pick another neighbour set.
    """
    X, _ = blobs
    jseen = _capture(jtsne, monkeypatch)
    jtsne.tsne_embed(X, perplexity=perplexity)
    jY0, jrows, jcols, jvals = (np.asarray(a) for a in jseen["args"][:4])
    tseen = _capture(ttsne, monkeypatch)
    ttsne.tsne_embed(X, perplexity=perplexity, device=CPU)
    tY0, trows, tcols, tvals = (a.numpy() for a in tseen["args"][:4])
    npt.assert_array_equal(tY0, jY0[: len(X)])
    npt.assert_array_equal(trows, jrows)
    npt.assert_array_equal(tcols, jcols)
    npt.assert_allclose(tvals, jvals, rtol=1e-5)


@pytest.mark.parametrize("perplexity", [5.0, 30.0, 45.0])
def test_tsne_beta_search_matches_jax(blobs, perplexity):
    """The conditional affinities from the same squared distances at rtol 1e-5 (atol 1e-12)."""
    X, _ = blobs
    k = int(min(len(X) - 1, 3 * perplexity))
    dists, _ = j_knn(X, k + 1)
    d2 = dists[:, 1:] ** 2
    want = np.asarray(jtsne._binary_search_beta(d2, np.log(perplexity)))
    got = ttsne._binary_search_beta(torch.from_numpy(d2), float(np.log(perplexity))).numpy()
    npt.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("learning_rate,n_iter", [(200.0, 1), (10.0, 1), (10.0, 20)])
def test_tsne_iterations_match_jax(blobs, learning_rate, n_iter):
    """From the same Y0 and affinities: the layout at rtol 1e-4 and atol 1e-4 × its largest coordinate.

    Found: 2e-9 of 0.055 after 1 iteration at the default learning rate
    200; at learning rate 10, 1e-10 of 0.0025 after 1 and 7e-8 of 0.006
    after 20.
    """
    X, _ = blobs
    kw = dict(perplexity=20, n_iter=n_iter, learning_rate=learning_rate, seed=0)
    want = jtsne.tsne_embed(X, **kw)
    got = ttsne.tsne_embed(X, device=CPU, **kw)
    npt.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def test_tsne_twenty_default_iterations_keep_the_jax_geometry(blobs):
    """20 iterations at the default learning rate: the pairwise distances correlate at ≥ 0.99.

    At learning rate 200 with early exaggeration, float32 rounding in another
    summation order grows about 2.5× an iteration (found: 2e-9 after 1,
    2e-3 after 12, 2.1 of a layout 24 wide after 20), so coordinates are not
    comparable there; the layouts' geometry is (found: 0.9988).
    """
    from scipy.spatial.distance import pdist

    X, _ = blobs
    want = jtsne.tsne_embed(X, perplexity=20, n_iter=20, seed=0)
    got = ttsne.tsne_embed(X, perplexity=20, n_iter=20, seed=0, device=CPU)
    assert np.corrcoef(pdist(got), pdist(want))[0, 1] >= 0.99


def test_tsne_separates_blobs_and_reruns_bit_identical(blobs):
    X, labels = blobs
    emb = ttsne.tsne_embed(X, n_iter=400, perplexity=20, seed=0, device=CPU)
    assert emb.shape == (150, 2) and np.isfinite(emb).all()
    assert _blob_separation(emb, labels) > 2.0
    npt.assert_array_equal(ttsne.tsne_embed(X, n_iter=400, perplexity=20, seed=0, device=CPU), emb)


def test_umap_tsne_trustworthiness(blobs):
    """sklearn's trustworthiness (``tests/test_downstream.py:158-182``): > 0.90 for both layouts."""
    trustworthiness = pytest.importorskip("sklearn.manifold").trustworthiness
    X, _ = blobs
    conn = t_fuzzy(*t_knn(X, 15, device=CPU), device=CPU)
    emb_u = tumap.umap_layout(conn, n_epochs=200, seed=0, device=CPU)
    emb_t = ttsne.tsne_embed(X, n_iter=400, perplexity=20, seed=0, device=CPU)
    emb_r = np.random.default_rng(0).normal(size=(X.shape[0], 2))
    assert trustworthiness(X, emb_u, n_neighbors=12) > 0.90
    assert trustworthiness(X, emb_t, n_neighbors=12) > 0.90
    assert trustworthiness(X, emb_r, n_neighbors=12) < 0.75


def test_tsne_max_cells_guard():
    X = np.random.default_rng(0).normal(size=(64, 5)).astype(np.float32)
    with pytest.raises(ValueError, match="max_cells"):
        ttsne.tsne_embed(X, max_cells=50, device=CPU)
    assert ttsne.tsne_embed(X, max_cells=None, n_iter=20, device=CPU).shape == (64, 2)


def test_products_run_with_tf32_off_whatever_the_global_flag(blobs):
    """``full_f32_matmul`` turns TF32 off inside and restores the caller's flag."""
    from infercnvpy_tpu_torch._util import full_f32_matmul

    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with full_f32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
        X, _ = blobs
        d1, i1 = t_knn(X, 15, device=CPU)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    d2, i2 = t_knn(X, 15, device=CPU)
    npt.assert_array_equal(d1, d2)
    npt.assert_array_equal(i1, i2)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def analysed():
    """The 183-cell stand-in through the port's ``tl.infercnv``, PCA and graph on the CPU."""
    adata = tcnv.datasets.oligodendroglioma()
    tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=CATS, device=CPU)
    tcnv.tl.pca(adata, device=CPU)
    tcnv.pp.neighbors(adata, device=CPU)
    tcnv.tl.leiden(adata)
    return adata


_ENTRY_POINTS = {
    "tl.pca": lambda a, **kw: tcnv.tl.pca(a, **kw),
    "pp.neighbors": lambda a, **kw: tcnv.pp.neighbors(a, **kw),
    "tl.umap": lambda a, **kw: tcnv.tl.umap(a, n_epochs=20, **kw),
    "tl.tsne": lambda a, **kw: tcnv.tl.tsne(a, n_iter=20, **kw),
    "tl.cnv_score": lambda a, **kw: tcnv.tl.cnv_score(a, **kw),
    "tl.ithcna": lambda a, **kw: tcnv.tl.ithcna(a, "cnv_leiden", **kw),
    "tl.ithgex": lambda a, **kw: tcnv.tl.ithgex(a, "cnv_leiden", **kw),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_needs_a_gpu_by_default_and_runs_on_the_cpu(analysed, monkeypatch, name):
    """``device=None`` means the CUDA device: without one it raises and names ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=f'{name} runs on a CUDA device.*device="cpu"'):
        _ENTRY_POINTS[name](analysed.copy())
    _ENTRY_POINTS[name](analysed.copy(), device=CPU)


def test_host_only_entry_points_run_without_a_gpu(analysed, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    adata = analysed.copy()
    tcnv.tl.leiden(adata, key_added="again")
    npt.assert_array_equal(adata.obs["again"].values, adata.obs["cnv_leiden"].values)


def test_entry_points_write_the_jax_slots(analysed):
    """The AnnData slots of each entry point, next to the JAX package's on the same X_cnv.

    From the graph on, the JAX package is given the port's connectivities: its
    own count the point itself in the sigma search (``ROADMAP.md`` A, defect 5).
    """
    ours = analysed.copy()
    ref = cnv.AnnData(X=ours.X, obs=ours.obs[["cell_type"]].copy(), var=ours.var.copy())
    ref.obsm["X_cnv"] = ours.obsm["X_cnv"]
    cnv.tl.pca(ref)
    cnv.pp.neighbors(ref)
    ref.obsp["cnv_neighbors_connectivities"] = ours.obsp["cnv_neighbors_connectivities"].copy()
    cnv.tl.leiden(ref)
    for a, t in ((ref, cnv.tl), (ours, tcnv.tl)):
        t.cnv_score(a, **({} if t is cnv.tl else {"device": CPU}))
        t.umap(a, **({"n_epochs": 30} if t is cnv.tl else {"n_epochs": 30, "device": CPU}))
        t.tsne(a, **({"n_iter": 30} if t is cnv.tl else {"n_iter": 30, "device": CPU}))
    assert set(ref.obsm) == set(ours.obsm)
    assert set(ref.obsp) == set(ours.obsp)
    assert set(ref.uns) >= {"cnv_pca", "cnv_neighbors", "cnv_leiden"} and set(ref.uns) <= set(ours.uns)
    assert ours.uns["cnv_neighbors"] == ref.uns["cnv_neighbors"]
    assert ours.uns["cnv_leiden"] == ref.uns["cnv_leiden"]
    npt.assert_allclose(ours.uns["cnv_pca"]["variance"], ref.uns["cnv_pca"]["variance"], rtol=1e-4)
    for key in ("X_cnv_pca", "X_cnv_umap", "X_cnv_tsne"):
        assert ours.obsm[key].shape == ref.obsm[key].shape
    # the JAX package's PCA is float64 here only because the tests turn x64 on; its default is float32
    assert ours.obsm["X_cnv_pca"].dtype == ours.obsm["X_cnv_umap"].dtype == ours.obsm["X_cnv_tsne"].dtype == np.float32
    assert isinstance(ours.obs["cnv_leiden"].dtype, pd.CategoricalDtype)
    assert list(ours.obs["cnv_leiden"].cat.categories) == list(ref.obs["cnv_leiden"].cat.categories)


def _ari(a, b):
    from scipy.special import comb

    _, inv_a = np.unique(a, return_inverse=True)
    _, inv_b = np.unique(b, return_inverse=True)
    C = np.zeros((inv_a.max() + 1, inv_b.max() + 1), dtype=np.int64)
    np.add.at(C, (inv_a, inv_b), 1)
    sum_c = comb(C, 2).sum()
    sum_a = comb(C.sum(axis=1), 2).sum()
    sum_b = comb(C.sum(axis=0), 2).sum()
    expected = sum_a * sum_b / comb(len(a), 2)
    return (sum_c - expected) / ((sum_a + sum_b) / 2 - expected)


def test_workflow_matches_jax():
    """The slice as a whole on the 183-cell stand-in: the verify recipe in both packages.

    ``tl.infercnv`` → ``tl.pca`` → ``pp.neighbors`` in both: the same PCA and
    the same kNN distances.  The graphs differ by design (the JAX package's
    sigma search counts the point itself, ``ROADMAP.md`` A, defect 5), so from
    the graph on both packages take the port's connectivities: ``tl.leiden``
    → ``tl.cnv_score`` give the same partition (ARI ≥ 0.95), every cluster is
    ≥ 95 % one class (malignant or normal), and the malignant cells' mean
    ``cnv_score`` is ≥ 3× the normal cells'.
    """
    results = {}
    for name, pkg, kw in (("jax", cnv, {}), ("torch", tcnv, {"device": CPU})):
        adata = pkg.datasets.oligodendroglioma()
        pkg.tl.infercnv(adata, reference_key="cell_type", reference_cat=CATS, **kw)
        pkg.tl.pca(adata, **kw)
        pkg.pp.neighbors(adata, **kw)
        results[name] = adata
    j, t = results["jax"], results["torch"]
    npt.assert_allclose(t.obsm["X_cnv_pca"], j.obsm["X_cnv_pca"], rtol=1e-4, atol=1e-4)
    npt.assert_allclose(t.obsp["cnv_neighbors_distances"].toarray(), j.obsp["cnv_neighbors_distances"].toarray(),
                        rtol=1e-4, atol=1e-4)
    j.obsp["cnv_neighbors_connectivities"] = t.obsp["cnv_neighbors_connectivities"].copy()
    for pkg, adata in ((cnv, j), (tcnv, t)):
        pkg.tl.leiden(adata)
        pkg.tl.cnv_score(adata, **({} if pkg is cnv else {"device": CPU}))
    assert _ari(t.obs["cnv_leiden"].values, j.obs["cnv_leiden"].values) >= 0.95
    malignant = (t.obs["cell_type"] == "Malignant").values
    for label in t.obs["cnv_leiden"].cat.categories:
        share = malignant[(t.obs["cnv_leiden"] == label).values].mean()
        assert max(share, 1.0 - share) >= 0.95, (label, share)
    score = t.obs["cnv_score"].values
    assert score[malignant].mean() >= 3.0 * score[~malignant].mean()


def test_new_modules_import_no_jax():
    code = (
        "import sys, infercnvpy_tpu_torch, infercnvpy_tpu_torch.pp, infercnvpy_tpu_torch.ops.linalg, "
        "infercnvpy_tpu_torch.ops.knn, infercnvpy_tpu_torch.ops.graph, infercnvpy_tpu_torch.ops.leiden, "
        "infercnvpy_tpu_torch.ops.corr, infercnvpy_tpu_torch.ops.umap_, infercnvpy_tpu_torch.ops.tsne_, "
        "infercnvpy_tpu_torch.tl._scores, infercnvpy_tpu_torch.native as nat\n"
        "import numpy as np\n"
        "labels = nat.leiden(np.array([0, 1, 2]), np.array([1, 0]), np.array([1.0, 1.0]), resolution=1.0, seed=0, "
        "max_rounds=5)\n"
        "assert list(labels) == [0, 0], labels\n"
        "assert 'jax' not in sys.modules and 'infercnvpy_tpu' not in sys.modules, sorted(sys.modules)"
    )
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300)
