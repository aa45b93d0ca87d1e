"""The port's Leiden (``native/leiden.cpp`` and ``ops.leiden.leiden_plain``) against ``infercnvpy_tpu``.

Both packages build the same C++ source with the same flags and seed its
``std::mt19937_64`` alike, so the native labels are equal, not just similar;
``leiden_plain`` is the JAX package's Python Leiden and equals it label for
label.  Plus the planted-partition, determinism, size-order and resolution
tests of ``tests/test_leiden.py`` on the port.
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from infercnvpy_tpu.native import native_available  # noqa: E402
from infercnvpy_tpu.ops.graph import fuzzy_connectivities as j_fuzzy  # noqa: E402
from infercnvpy_tpu.ops.knn import exact_knn as j_knn  # noqa: E402
from infercnvpy_tpu.ops.leiden import leiden as j_leiden  # noqa: E402
from infercnvpy_tpu_torch import native  # noqa: E402
from infercnvpy_tpu_torch.ops.leiden import leiden, leiden_plain  # noqa: E402


def _planted_partition(n_per=60, k=3, p_in=0.25, p_out=0.01, seed=0):
    """``tests/test_leiden.py``'s graph: k groups, dense inside, sparse across."""
    rng = np.random.default_rng(seed)
    n = n_per * k
    truth = np.repeat(np.arange(k), n_per)
    upper = np.triu(rng.random((n, n)), 1)
    p = np.where(truth[:, None] == truth[None, :], p_in, p_out)
    rows, cols = np.nonzero((upper > 0) & (upper < p))
    A = sp.csr_matrix((np.ones(2 * len(rows)), (np.r_[rows, cols], np.r_[cols, rows])), shape=(n, n))
    return A, truth


def _knn_graph(seed=0, n=240, k=15):
    """A weighted fuzzy kNN graph of four Gaussian clusters, as ``pp.neighbors`` makes one."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(4, 10))
    X = (centers[np.repeat(np.arange(4), n // 4)] + rng.normal(size=(n, 10))).astype(np.float32)
    return j_fuzzy(*j_knn(X, k))


def _ari(a, b):
    """Adjusted Rand index (``tests/test_leiden.py``)."""
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


_GRAPHS = {
    "planted_0": lambda: _planted_partition(seed=0)[0],
    "planted_3": lambda: _planted_partition(seed=3)[0],
    "planted_2x40": lambda: _planted_partition(n_per=40, k=2, seed=2)[0],
    "knn_0": lambda: _knn_graph(seed=0),
    "knn_5": lambda: _knn_graph(seed=5),
}


@pytest.fixture(scope="module")
def native_built():
    if not native_available():
        pytest.skip("the JAX package's native Leiden did not build (no g++)")
    native.build_leiden()


@pytest.mark.parametrize("resolution,seed", [(1.0, 0), (1.0, 42), (0.3, 7), (2.5, 1)])
@pytest.mark.parametrize("graph", sorted(_GRAPHS))
def test_native_labels_equal_jax_native(native_built, graph, resolution, seed):
    A = _GRAPHS[graph]()
    want = j_leiden(A, resolution=resolution, seed=seed, use_native=True)
    got = leiden(A, resolution=resolution, seed=seed)
    assert got.dtype == np.int64
    npt.assert_array_equal(got, want)


@pytest.mark.parametrize("resolution,seed", [(1.0, 0), (0.5, 11)])
@pytest.mark.parametrize("graph", ["planted_0", "planted_2x40", "knn_0"])
def test_plain_labels_equal_jax_python(graph, resolution, seed):
    A = _GRAPHS[graph]()
    want = j_leiden(A, resolution=resolution, seed=seed, use_native=False)
    npt.assert_array_equal(leiden_plain(A, resolution=resolution, seed=seed), want)


@pytest.mark.parametrize("fn", [leiden, leiden_plain], ids=["native", "plain"])
def test_planted_partition(fn):
    A, truth = _planted_partition()
    assert _ari(truth, fn(A)) > 0.95


@pytest.mark.parametrize("fn", [leiden, leiden_plain], ids=["native", "plain"])
def test_deterministic(fn):
    A, _ = _planted_partition(seed=3)
    npt.assert_array_equal(fn(A, seed=42), fn(A, seed=42))


def test_native_matches_plain_partition():
    A, _ = _planted_partition(seed=1)
    assert _ari(leiden(A), leiden_plain(A)) > 0.95


@pytest.mark.parametrize("fn", [leiden, leiden_plain], ids=["native", "plain"])
def test_labels_ordered_by_size(fn):
    A, _ = _planted_partition(n_per=40, k=2, seed=2)
    _, counts = np.unique(fn(A), return_counts=True)
    assert (np.diff(counts) <= 0).all()


@pytest.mark.parametrize("fn", [leiden, leiden_plain], ids=["native", "plain"])
def test_resolution_monotone(fn):
    A, _ = _planted_partition(seed=4)
    assert len(set(fn(A, resolution=0.1))) <= len(set(fn(A, resolution=3.0)))


def test_library_is_built_into_the_build_dir_from_the_source():
    path = native.build_leiden()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libinfercnv_leiden-") and path.exists()
    assert native.leiden_library() is native.leiden_library()


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """A leiden.cpp that does not compile raises with g++'s message; no Python Leiden runs instead."""
    broken = tmp_path / "leiden.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_LEIDEN_SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LEIDEN_LIB", None)
    A, _ = _planted_partition(n_per=10, k=2)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        leiden(A)
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize(
    "indptr,indices,weights,err",
    [
        ([0, 1, 3], [1, 0], [1.0, 1.0], ValueError),  # indptr past the indices
        ([0, 1, 2], [1, 0], [1.0], ValueError),  # one weight short
        ([0, 1, 2], [1, 2], [1.0, 1.0], IndexError),  # a neighbour that is no node
        ([0, 2, 1, 2], [1, 0], [1.0, 1.0], ValueError),  # indptr falls
    ],
)
def test_native_wrapper_checks_the_graph(indptr, indices, weights, err):
    with pytest.raises(err):
        native.leiden(np.array(indptr), np.array(indices), np.array(weights), resolution=1.0, seed=0, max_rounds=5)
