"""The port's ``datasets.maynard2020_3k`` against ``infercnvpy_tpu``'s, offline.

The cached-file branch reads a small h5ad written at the port's cache path.
With ``urlretrieve`` stubbed to fail, the call raises the same
``RuntimeError`` as the JAX package's, and ``allow_synthetic=True`` gives the
same synthetic stand-in (``X``, ``obs``, ``var``).  No test downloads a file.
"""

import urllib.request

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import infercnvpy_tpu as cnv  # noqa: E402
import infercnvpy_tpu_torch as tcnv  # noqa: E402
from infercnvpy_tpu import settings as jsettings  # noqa: E402
from infercnvpy_tpu_torch import settings as tsettings  # noqa: E402

URL = "https://github.com/icbi-lab/infercnvpy/releases/download/d0.1.0/maynard2020_3k.h5ad"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def offline(tmp_path, monkeypatch):
    """Each package's ``datasetdir`` in its own empty folder; ``urlretrieve`` fails and records its calls."""
    monkeypatch.setattr(tsettings, "datasetdir", tmp_path / "port")
    monkeypatch.setattr(jsettings, "datasetdir", tmp_path / "jax")
    calls = []

    def boom(url, filename, *a, **k):
        calls.append((url, filename))
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlretrieve", boom)
    return tmp_path, calls


def test_maynard_cached_file(offline):
    tmp_path, calls = offline
    small = tcnv.datasets.synthetic_cnv_dataset(n_cells=30, n_genes=120, seed=4)
    (tmp_path / "port").mkdir()
    small.write_h5ad(tmp_path / "port" / "maynard2020_3k.h5ad")
    got = tcnv.datasets.maynard2020_3k()
    assert calls == []
    assert isinstance(got, tcnv.AnnData) and sp.issparse(got.X)
    npt.assert_array_equal(got.X.toarray(), small.X.toarray())
    pd.testing.assert_frame_equal(got.obs, small.obs)
    pd.testing.assert_frame_equal(got.var, small.var)


def test_maynard_download_failure_raises(offline):
    tmp_path, calls = offline
    with pytest.raises(RuntimeError) as got:
        tcnv.datasets.maynard2020_3k()
    with pytest.raises(RuntimeError) as want:
        cnv.datasets.maynard2020_3k()
    assert calls == [(URL, tmp_path / "port" / "maynard2020_3k.h5ad"), (URL, tmp_path / "jax" / "maynard2020_3k.h5ad")]
    assert str(got.value) == str(want.value).replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert isinstance(got.value.__cause__, OSError)


def test_maynard_synthetic_fallback(offline, capsys):
    tmp_path, calls = offline
    capsys.readouterr()
    got = tcnv.datasets.maynard2020_3k(allow_synthetic=True)
    err_t = capsys.readouterr().err
    want = cnv.datasets.maynard2020_3k(allow_synthetic=True)
    assert err_t == capsys.readouterr().err
    assert "generating a synthetic 3000-cell stand-in" in err_t
    assert got.shape == want.shape == (3000, 6000)
    assert got.X.dtype == want.X.dtype and type(got.X) is type(want.X)
    npt.assert_array_equal(got.X.indptr, want.X.indptr)
    npt.assert_array_equal(got.X.indices, want.X.indices)
    npt.assert_array_equal(got.X.data, want.X.data)
    pd.testing.assert_frame_equal(got.obs, want.obs)
    pd.testing.assert_frame_equal(got.var, want.var)
    assert got.uns["synthetic"] == want.uns["synthetic"] and got.uns["synthetic"]["seed"] == 2020
    assert not (tmp_path / "port" / "maynard2020_3k.h5ad").exists()
    assert np.isfinite(got.X.data).all()
