"""The port's ``tl.copykat`` bridge against ``infercnvpy_tpu``'s, without R.

The cases of ``tests/test_copykat.py``, each run through both packages on the
same inputs: expression marshalling to R's genes × cells frame, the storage
of copyKAT's outputs in the AnnData slots, and the ``ImportError`` without
rpy2.  The R call itself needs rpy2 and R, which the test machines lack.
"""

import sys

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import infercnvpy_tpu as cnv  # noqa: E402
import infercnvpy_tpu.tl._copykat as jck  # noqa: E402
import infercnvpy_tpu_torch as tcnv  # noqa: E402
import infercnvpy_tpu_torch.tl._copykat as tck  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(5, 7)).astype(np.float32)
    obs = pd.DataFrame(index=[f"cell{i}" for i in range(5)])
    var = pd.DataFrame(index=[f"gene{j}" for j in range(7)])
    return (
        tcnv.AnnData(X=X.copy(), obs=obs.copy(), var=var.copy()),
        cnv.AnnData(X=X.copy(), obs=obs.copy(), var=var.copy()),
    )


def _fake_cna(cells, n_windows=6):
    """CNAmat-shaped frame: windows x (chrom, chrompos, abspos, cells...)."""
    rng = np.random.default_rng(1)
    cna = pd.DataFrame(
        {
            "chrom": [1, 1, 1, 2, 2, 3][:n_windows],
            "chrompos": np.arange(n_windows) * 5_000_000,
            "abspos": np.arange(n_windows) * 5_000_000,
        }
    )
    for c in cells:
        cna[c] = rng.normal(size=n_windows)
    return cna


def test_to_r_matrix_df_is_genes_by_cells():
    a_t, a_j = _pair()
    got = tck._to_r_matrix_df(a_t.X, a_t)
    pd.testing.assert_frame_equal(got, jck._to_r_matrix_df(a_j.X, a_j))
    assert list(got.index) == list(a_t.var_names) and list(got.columns) == list(a_t.obs_names)
    npt.assert_array_equal(got.values, np.asarray(a_t.X).T)


PRED_CASES = {
    "index": lambda cells: pd.DataFrame(
        {"copykat.pred": ["aneuploid", "diploid", "diploid", "aneuploid", "diploid"]}, index=cells
    ),
    "missing_cells": lambda cells: pd.DataFrame({"copykat.pred": ["diploid", "aneuploid"]}, index=cells[:2]),
    "cell_names_column": lambda cells: pd.DataFrame({"cell.names": cells, "copykat.pred": ["d"] * 5}),
}


def _assert_same_store(a_t, a_j, key):
    assert a_t.uns[key] == a_j.uns[key]
    npt.assert_array_equal(a_t.obsm[f"X_{key}"], a_j.obsm[f"X_{key}"])
    pd.testing.assert_frame_equal(a_t.obs, a_j.obs)


@pytest.mark.parametrize("key", ["cnv", "ck"])
@pytest.mark.parametrize("case", list(PRED_CASES))
def test_store_copykat_inplace(case, key):
    a_t, a_j = _pair()
    cells = list(a_t.obs_names)
    cna = _fake_cna(cells)
    pred = PRED_CASES[case](cells)
    assert tck._store_copykat(a_t, cna.copy(), pred.copy(), key, inplace=True) is None
    assert jck._store_copykat(a_j, cna.copy(), pred.copy(), key, inplace=True) is None
    _assert_same_store(a_t, a_j, key)
    assert a_t.uns[key] == {"chr_pos": {"chr1": 0, "chr2": 3, "chr3": 5}}
    npt.assert_array_equal(a_t.obsm[f"X_{key}"], cna[cells].T.values)
    if case == "missing_cells":
        assert list(a_t.obs[key][:2]) == ["diploid", "aneuploid"] and a_t.obs[key][2:].isna().all()


def test_store_copykat_not_inplace():
    a_t, a_j = _pair()
    cells = list(a_t.obs_names)
    cna = _fake_cna(cells)
    pred = pd.DataFrame({"copykat.pred": ["d"] * 5}, index=cells)
    mtx, series = tck._store_copykat(a_t, cna, pred, "cnv", inplace=False)
    j_mtx, j_series = jck._store_copykat(a_j, cna, pred, "cnv", inplace=False)
    npt.assert_array_equal(mtx, j_mtx)
    pd.testing.assert_series_equal(series, j_series)
    assert mtx.shape == (5, 6) and "X_cnv" not in a_t.obsm


def test_copykat_requires_rpy2(monkeypatch):
    """Without rpy2 both bridges raise the same ``ImportError`` before touching the data."""
    monkeypatch.setitem(sys.modules, "rpy2", None)
    a_t, a_j = _pair()
    with pytest.raises(ImportError) as got:
        tcnv.tl.copykat(a_t)
    with pytest.raises(ImportError) as want:
        cnv.tl.copykat(a_j)
    assert str(got.value) == str(want.value)
    assert "rpy2" in str(got.value) and got.value.__cause__ is None
    assert "X_cnv" not in a_t.obsm
