"""The port's scores (``tl.cnv_score`` / ``ithcna`` / ``ithgex``, ``ops.corr``) against ``infercnvpy_tpu``.

``cnv_score`` is the same host numpy code in both packages: rtol 1e-12.
``ithcna`` / ``ithgex`` quartiles over the correlation matrices: rtol 1e-9
(the port's device correlations are float64 products in another order than
``np.corrcoef``).  The golden values of ``tests/test_scores.py:9-33``, on the
port's ``AnnData``.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import infercnvpy_tpu as cnv  # noqa: E402
import infercnvpy_tpu.tl._scores as jscores  # noqa: E402
import infercnvpy_tpu_torch as tcnv  # noqa: E402
import infercnvpy_tpu_torch.tl._scores as tscores  # noqa: E402
from infercnvpy_tpu.ops.corr import pearson_rows as j_pearson  # noqa: E402
from infercnvpy_tpu_torch.ops.corr import pearson_rows as t_pearson  # noqa: E402

CPU = "cpu"
REPS = [np.array, sp.csr_matrix, sp.csc_matrix]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(params=REPS, ids=["dense", "csr", "csc"])
def adata_ithgex(request):
    """``tests/conftest.py::adata_ithgex`` on the port's AnnData."""
    return tcnv.AnnData(
        X=request.param(
            np.array([[1, 1, 1, 1, 1, 1, 2, 3], [2, 2, 2, 2, 2, 2, 8, 0], [3, 3, 3, 3, 3, 10, 3, 7]]).T
        ),
        obsm={
            "X_cnv": request.param(
                np.array(
                    [[1, 1, 1, 2, 2, 1, 1, 1], [2, 2, 2, 1, 1, 2, 2, 2], [4, 4, 4, 2, 2, 3, 3, 3], [2, 2, 2, 4, 4, 4, 4, 4]]
                ).T
            )
        },
        obs=pd.DataFrame(index=["c1", "c2", "c3", "c4", "c5", "c6", "c7", "c8"]).assign(group=list("AAAAABBB")),
        var=pd.DataFrame(index=["x", "y", "z"]),
    )


def test_ithgex(adata_ithgex):
    res = tcnv.tl.ithgex(adata_ithgex, "group", inplace=False, device=CPU)
    assert res["A"] == 0
    assert res["B"] == pytest.approx(1.2628, abs=0.001)


def test_ithcna(adata_ithgex):
    res = tcnv.tl.ithcna(adata_ithgex, "group", inplace=False, device=CPU)
    assert res["A"] == pytest.approx(1.053, abs=0.001)
    assert res["B"] == 0


def test_cnv_score(adata_ithgex):
    res = tcnv.tl.cnv_score(adata_ithgex, "group", inplace=False, device=CPU)
    assert res["A"] == pytest.approx(2.25, abs=0.001)
    assert res["B"] == pytest.approx(2.5, abs=0.001)


def test_scores_inplace(adata_ithgex):
    tcnv.tl.ithgex(adata_ithgex, "group", device=CPU)
    tcnv.tl.ithcna(adata_ithgex, "group", device=CPU)
    tcnv.tl.cnv_score(adata_ithgex, "group", device=CPU)
    assert {"ithgex", "ithcna", "cnv_score"} <= set(adata_ithgex.obs.columns)


def test_cnv_score_needs_leiden_and_warns_on_obs_key(adata_ithgex):
    with pytest.raises(ValueError, match="`cnv_leiden` not found"):
        tcnv.tl.cnv_score(adata_ithgex)
    with pytest.warns(FutureWarning, match="obs_key"):
        tcnv.tl.cnv_score(adata_ithgex, obs_key="group", device=CPU)


def _pair(rep, seed=0, n=500, d=180, n_groups=5, dtype=np.float32):
    """The same random CNV-like data in the port's and the JAX package's AnnData."""
    rng = np.random.default_rng(seed)
    X_cnv = (rng.normal(size=(n, d)) * (rng.random((n, d)) < 0.4)).astype(dtype)
    X = rng.gamma(2.0, size=(n, 60)).astype(np.float32)
    groups = rng.integers(0, n_groups, size=n).astype(str)
    groups[:3] = "tiny"  # a group of 3 cells; and one of 1 below
    groups[3] = "single"
    obs = pd.DataFrame({"grp": pd.Categorical(groups)}, index=[f"c{i}" for i in range(n)])
    var = pd.DataFrame(index=[f"g{i}" for i in range(60)])
    mk = dict(X=rep(X), obs=obs, var=var, obsm={"X_cnv": rep(X_cnv)})
    return tcnv.AnnData(**mk), cnv.AnnData(**{**mk, "obs": obs.copy(), "obsm": {"X_cnv": rep(X_cnv)}})


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rep", REPS, ids=["dense", "csr", "csc"])
def test_cnv_score_matches_jax(rep, dtype):
    ours, ref = _pair(rep, dtype=dtype)
    got = tcnv.tl.cnv_score(ours, "grp", inplace=False, device=CPU)
    want = cnv.tl.cnv_score(ref, "grp", inplace=False)
    assert set(got) == set(want)
    for g in want:
        npt.assert_allclose(got[g], want[g], rtol=1e-12)
    tcnv.tl.cnv_score(ours, "grp", device=CPU)
    cnv.tl.cnv_score(ref, "grp")
    npt.assert_allclose(ours.obs["cnv_score"].values, ref.obs["cnv_score"].values, rtol=1e-12)


@pytest.fixture(params=[False, True], ids=["numpy_corr", "device_corr"])
def corr_route(request, monkeypatch):
    """Route every group through ``np.corrcoef`` or through ``ops.corr.pearson_rows``.

    Groups here are ≤ 600 cells × ≤ 180 features, under the 512 × 512
    elements where the port moves to the device; the threshold is lowered to
    reach that path.
    """
    if request.param:
        monkeypatch.setattr(tscores, "_DEVICE_MIN_ELEMENTS", 16)
    return request.param


@pytest.mark.parametrize("rep", REPS, ids=["dense", "csr", "csc"])
def test_ithcna_matches_jax(rep, corr_route):
    ours, ref = _pair(rep, seed=1)
    got = tcnv.tl.ithcna(ours, "grp", inplace=False, device=CPU)
    want = cnv.tl.ithcna(ref, "grp", inplace=False)
    assert set(got) == set(want) and "single" not in got
    for g in want:
        npt.assert_allclose(got[g], want[g], rtol=1e-9)
    tcnv.tl.ithcna(ours, "grp", device=CPU)
    cnv.tl.ithcna(ref, "grp")
    npt.assert_allclose(ours.obs["ithcna"].values, ref.obs["ithcna"].values, rtol=1e-9)
    assert np.isnan(ours.obs["ithcna"].values[3])


@pytest.mark.parametrize("rep", REPS, ids=["dense", "csr", "csc"])
def test_ithgex_matches_jax(rep, corr_route):
    ours, ref = _pair(rep, seed=2)
    got = tcnv.tl.ithgex(ours, "grp", inplace=False, device=CPU)
    want = cnv.tl.ithgex(ref, "grp", inplace=False)
    assert set(got) == set(want)
    for g in want:
        npt.assert_allclose(got[g], want[g], rtol=1e-9)


@pytest.mark.parametrize("shape", [(2, 5), (40, 180), (600, 120)])
def test_pearson_rows_matches_jax_and_numpy(shape):
    """float64 on the device against the JAX x64 branch and ``np.corrcoef``: atol 1e-12."""
    rng = np.random.default_rng(shape[0])
    X = rng.normal(size=shape) * rng.gamma(2.0, size=(shape[0], 1)) + 1.5
    got = t_pearson(X, device=CPU)
    assert got.dtype == np.float64 and got.shape == (shape[0], shape[0])
    npt.assert_allclose(got, np.asarray(j_pearson(X)), rtol=0, atol=1e-12)
    npt.assert_allclose(got, np.corrcoef(X, rowvar=True), rtol=0, atol=1e-12)


def test_device_switchover_is_the_jax_one():
    assert tscores._DEVICE_MIN_ELEMENTS == jscores._JAX_MIN_ELEMENTS
