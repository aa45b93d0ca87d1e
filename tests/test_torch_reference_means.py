"""The reference means of ``tl.infercnv`` (``_get_reference``): one native pass over the caller's CSR.

CSR input with float32, float64 or integer values and int32 column ids takes
``native.reference_sums``; every other input takes the plain ``_mean0``
(scipy / numpy).  Each case is held ``np.array_equal``, dtype included,
against the plain path (``_mean0`` of each category's rows, as the JAX
package selects them) and against the JAX package's ``_get_reference``:
every value layout a CSR can hold, every way of naming the categories, every
kind of label column, ``layer=``, the fallback over all cells and an explicit
reference; the error and warning texts are the JAX package's.
"""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import infercnvpy_tpu_torch as tcnv  # noqa: E402
from infercnvpy_tpu.tl import _infercnv as jax_drv  # noqa: E402
from infercnvpy_tpu_torch import native, profiling  # noqa: E402
from infercnvpy_tpu_torch.tl import _infercnv as drv  # noqa: E402

N_CELLS, N_GENES = 61, 37
#: cell types: "e" has one cell, "z" is a category no cell carries
TYPES = np.array(["a", "b", "c", "d"] * 15 + ["e"])
CATS = {"str": "a", "list": ["a", "b"], "tuple": ("c", "a"), "one_cell": ["e", "b"], "twice": ["a", "c", "a"]}
DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint16]
LAYOUTS = ["sorted", "unsorted", "duplicates", "explicit_zeros", "empty_rows"]


def _values(rng, dtype, n: int) -> np.ndarray:
    """Values whose sums depend on their order: magnitudes over six decades in floats, signed where the type is."""
    if np.dtype(dtype).kind == "f":
        return (rng.lognormal(0.0, 3.0, n) * rng.choice([-1.0, 1.0], n)).astype(dtype)
    lo = 0 if np.dtype(dtype).kind == "u" else -1000
    return rng.integers(lo, 1000, n).astype(dtype)


def _csr(dtype, layout: str, seed: int = 0) -> sp.csr_matrix:
    """An ``N_CELLS × N_GENES`` CSR with int32 column ids in ``layout``."""
    rng = np.random.default_rng(seed)
    x = sp.random(N_CELLS, N_GENES, density=0.4, format="csr", random_state=seed)
    indptr, indices = x.indptr.astype(np.int32), x.indices.astype(np.int32)
    data = _values(rng, dtype, len(indices))
    if layout == "unsorted":
        for r in range(N_CELLS):
            lo, hi = indptr[r], indptr[r + 1]
            order = rng.permutation(hi - lo)
            indices[lo:hi], data[lo:hi] = indices[lo:hi][order], data[lo:hi][order]
    elif layout == "duplicates":  # each row again, so every column it holds holds two entries
        rows = [np.concatenate([indices[indptr[r]:indptr[r + 1]]] * 2) for r in range(N_CELLS)]
        vals = [_values(rng, dtype, len(c)) for c in rows]
        indptr = np.concatenate([[0], np.cumsum([len(c) for c in rows])]).astype(np.int32)
        indices, data = np.concatenate(rows).astype(np.int32), np.concatenate(vals).astype(dtype)
    elif layout == "explicit_zeros":
        data[rng.random(len(data)) < 0.3] = 0
    elif layout == "empty_rows":  # rows of "a", "b" and "c" among them
        keep = np.ones(N_CELLS, dtype=bool)
        keep[[0, 1, 2, 4, 9]] = False
        lens = np.diff(indptr) * keep
        rows = [np.arange(indptr[r], indptr[r + 1]) for r in range(N_CELLS) if keep[r]]
        sel = np.concatenate(rows)
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        indices, data = indices[sel], data[sel]
    out = sp.csr_matrix((data, indices, indptr), shape=(N_CELLS, N_GENES))
    assert out.indices.dtype == np.int32 and out.data.dtype == np.dtype(dtype)
    return out


def _adata(X, labels=None, **layers) -> tcnv.AnnData:
    obs = pd.DataFrame({"cell_type": pd.Categorical(TYPES, categories=[*"abcde", "z"]) if labels is None else labels},
                       index=[f"c{i}" for i in range(N_CELLS)])
    return tcnv.AnnData(X=X, obs=obs, var=pd.DataFrame(index=[f"g{j}" for j in range(N_GENES)]), layers=layers)


def _plain(X, labels, cats) -> np.ndarray:
    """``_mean0`` of each category's rows, selected as the JAX package selects them."""
    labels = np.asarray(labels)
    cats = np.array([cats] if isinstance(cats, str) else list(cats))
    return np.vstack([drv._mean0(X[labels == cat, :]) for cat in cats])


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _native_calls(fn):
    before = native.reference_sums.calls
    out = fn()
    return out, native.reference_sums.calls - before


@pytest.mark.parametrize("cats", list(CATS))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_native_means_equal_the_plain_path_and_the_jax_package(dtype, layout, cats):
    X = _csr(dtype, layout)
    adata = _adata(X)
    got, calls = _native_calls(lambda: drv._get_reference(adata, "cell_type", CATS[cats], None, None))
    assert calls == 1
    _assert_same(got, _plain(X, TYPES, CATS[cats]))
    _assert_same(got, jax_drv._get_reference(adata, "cell_type", CATS[cats], None, None))
    assert got.dtype == (np.float32 if dtype == np.float32 else np.float64)


def _labels(kind: str):
    """A label column of ``kind`` and the categories to ask for in it."""
    if kind == "categorical":
        return pd.Categorical(TYPES, categories=["z", *"edcba"]), ["b", "e"]
    if kind == "categorical_nan":
        labels = np.where(np.arange(N_CELLS) % 5 == 0, None, TYPES)
        return pd.Categorical(labels, categories=[*"abcde", "z"]), ["a", "c"]
    if kind == "object":
        return np.array(TYPES, dtype=object), ["d", "a"]
    if kind == "object_nan":
        return np.array([np.nan if i % 7 == 0 else t for i, t in enumerate(TYPES)], dtype=object), ["a", "e"]
    if kind == "integer":
        return np.searchsorted(np.array(list("abcde")), TYPES).astype(np.int64), [1, 4, 1]
    if kind == "float_nan":
        codes = np.searchsorted(np.array(list("abcde")), TYPES)
        return np.where(np.arange(N_CELLS) % 4 == 1, np.nan, codes), [0.0, 2.0]
    raise AssertionError(kind)


LABEL_KINDS = ["categorical", "categorical_nan", "object", "object_nan", "integer", "float_nan"]


@pytest.mark.parametrize("kind", LABEL_KINDS)
def test_every_kind_of_label_column(kind):
    labels, cats = _labels(kind)
    X = _csr(np.float32, "sorted", seed=3)
    adata = _adata(X, labels)
    got, calls = _native_calls(lambda: drv._get_reference(adata, "cell_type", cats, None, None))
    assert calls == 1
    _assert_same(got, _plain(X, adata.obs["cell_type"].values, cats))
    _assert_same(got, jax_drv._get_reference(adata, "cell_type", cats, None, None))


@pytest.mark.parametrize("cats", [["z"], ["a", "z", "nope"], "nope", ["e", "z", "z"]])
@pytest.mark.parametrize("kind", ["categorical", "categorical_nan", "object"])
def test_an_absent_category_raises_the_unchanged_message(kind, cats):
    """A category the column lists but no cell carries (``"z"``), or one it does not list, raises the JAX
    package's text, with the same ``absent`` array."""
    labels = _labels(kind)[0]
    adata = _adata(_csr(np.float32, "sorted"), labels)
    with pytest.raises(ValueError) as ours:
        drv._get_reference(adata, "cell_type", cats, None, None)
    with pytest.raises(ValueError) as theirs:
        jax_drv._get_reference(adata, "cell_type", cats, None, None)
    assert str(ours.value) == str(theirs.value)
    assert "do not occur in `adata.obs['cell_type']`" in str(ours.value)


@pytest.mark.parametrize("dtype", [np.float32, np.int64], ids=["float32", "int64"])
def test_layer_is_read_in_place_of_x(dtype):
    counts = _csr(dtype, "unsorted", seed=5)
    adata = _adata(_csr(np.float64, "sorted", seed=6), counts=counts)
    got, calls = _native_calls(lambda: drv._get_reference(adata, "cell_type", ["b", "d"], None, "counts"))
    assert calls == 1
    _assert_same(got, _plain(counts, TYPES, ["b", "d"]))
    _assert_same(got, jax_drv._get_reference(adata, "cell_type", ["b", "d"], None, "counts"))


@pytest.mark.parametrize("missing", ["key", "cat"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32], ids=lambda d: np.dtype(d).name)
def test_the_fallback_over_all_cells_warns_and_takes_one_pass(dtype, missing, capsys):
    X = _csr(dtype, "duplicates", seed=7)
    adata = _adata(X)
    key, cat = (None, ["a"]) if missing == "key" else ("cell_type", None)
    got, calls = _native_calls(lambda: drv._get_reference(adata, key, cat, None, None))
    ours = capsys.readouterr().err
    want = jax_drv._get_reference(adata, key, cat, None, None)
    assert calls == 1 and ours == capsys.readouterr().err
    assert ours.startswith("WARNING: No reference given — falling back to the mean over ALL cells")
    _assert_same(got, want)
    _assert_same(got, drv._mean0(X)[np.newaxis, :])


def test_an_explicit_reference_is_returned_untouched():
    adata = _adata(_csr(np.float32, "sorted"))
    explicit = np.random.default_rng(0).normal(size=(2, N_GENES))
    got, calls = _native_calls(lambda: drv._get_reference(adata, "cell_type", "a", explicit, None))
    assert calls == 0 and np.array_equal(got, explicit)
    one, _ = _native_calls(lambda: drv._get_reference(adata, None, None, explicit[0], None))
    _assert_same(one, explicit[:1])
    with pytest.raises(ValueError, match="different gene count"):
        drv._get_reference(adata, None, None, explicit[:, 1:], None)


def _plain_inputs():
    x = _csr(np.float32, "sorted", seed=9)
    wide = x.copy()
    wide.indices = wide.indices.astype(np.int64)
    wide.indptr = wide.indptr.astype(np.int64)
    return {"dense": x.toarray(), "dense_int": _csr(np.int32, "sorted").toarray(), "csc": x.tocsc(),
            "int64_indices": wide, "bool": x.astype(bool), "dense_float16": x.toarray().astype(np.float16)}


@pytest.mark.parametrize("fmt", list(_plain_inputs()))
def test_other_input_takes_the_plain_path(tmp_path, fmt):
    X = _plain_inputs()[fmt]
    if fmt == "int64_indices":
        assert X.indices.dtype == np.int64
    adata = _adata(X)
    with profiling.trace(tmp_path), profiling.span("infercnv.reference"):
        got, calls = _native_calls(lambda: drv._get_reference(adata, "cell_type", ["c", "a", "c"], None, None))
    assert calls == 0
    _assert_same(got, _plain(X, TYPES, ["c", "a", "c"]))
    _assert_same(got, jax_drv._get_reference(adata, "cell_type", ["c", "a", "c"], None, None))
    [span] = profiling.last_spans
    assert span.attrs == {"path": "plain", "categories": 2} and span.counts == {"reference_nnz": 0}


def test_the_native_span_counts_the_values_it_summed(tmp_path):
    X = _csr(np.float64, "duplicates", seed=2)
    adata = _adata(X)
    with profiling.trace(tmp_path), profiling.span("infercnv.reference"):
        drv._get_reference(adata, "cell_type", ["b", "e", "b"], None, None)
    [span] = profiling.last_spans
    rows = np.isin(TYPES, ["b", "e"])
    assert span.attrs == {"path": "native", "categories": 2}
    assert span.counts == {"reference_nnz": int(np.diff(X.indptr)[rows].sum())} and span.counts["reference_nnz"] > 0


@pytest.mark.parametrize("threads", [1, 2, 8])
def test_the_thread_count_leaves_the_bits(threads):
    """One thread a slot, at most torch's count: every count gives the plain path's bits over all five
    categories."""
    X = _csr(np.float32, "unsorted", seed=4)
    adata = _adata(X)
    prev = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got = drv._get_reference(adata, "cell_type", list("edcba"), None, None)
    finally:
        torch.set_num_threads(prev)
    _assert_same(got, _plain(X, TYPES, list("edcba")))


def _wrapper_case(fault: str):
    x = _csr(np.float32, "sorted")
    indptr, indices, data = x.indptr.copy(), x.indices.copy(), x.data
    slot = np.where(TYPES == "a", 0, -1).astype(np.int32)
    first = int(np.flatnonzero(slot == 0)[0])
    other = int(np.flatnonzero(slot == -1)[0])
    if fault == "column_past_the_end":
        indices[indptr[first]] = N_GENES
    elif fault == "negative_column":
        indices[indptr[first + 4] + 1] = -1
    elif fault == "row_past_the_end":
        indptr[first + 1:] = len(indices) + 5
    elif fault == "unread_row":  # a bad id in a row of no slot is never read
        indices[indptr[other]] = 10 * N_GENES
    return indptr, indices, data, slot


@pytest.mark.parametrize("fault", ["column_past_the_end", "negative_column", "row_past_the_end", "unread_row"])
def test_the_wrapper_reports_an_index_out_of_bounds(fault):
    indptr, indices, data, slot = _wrapper_case(fault)
    scale = np.array([1.0 / np.count_nonzero(slot == 0)], dtype=np.float32)
    if fault == "unread_row":
        sums, n = native.reference_sums(indptr, indices, data, slot, scale, N_GENES)
        assert n == int(np.diff(indptr)[slot == 0].sum()) and sums.shape == (1, N_GENES)
        return
    with pytest.raises(IndexError, match="out|outside"):
        native.reference_sums(indptr, indices, data, slot, scale, N_GENES)


@pytest.mark.parametrize("bad", ["int64_indices", "float16_data", "short_slot"])
def test_the_wrapper_refuses_what_it_would_have_to_copy(bad):
    x = _csr(np.float32, "sorted")
    indices, data = x.indices, x.data
    slot = np.zeros(N_CELLS, dtype=np.int32)
    if bad == "int64_indices":
        indices = indices.astype(np.int64)
    elif bad == "float16_data":
        data = data.astype(np.float16)
    else:
        slot = slot[1:]
    with pytest.raises((TypeError, ValueError)):
        native.reference_sums(x.indptr, indices, data, slot, np.ones(1, np.float32), N_GENES)
