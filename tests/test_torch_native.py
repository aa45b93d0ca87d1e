"""The port's native host packers (``infercnvpy_tpu_torch/native/pack.cpp``).

Each is held bit for bit against the port's numpy reference beside it
(``ops/sparse_ingest.py::coo_from_csr_batch_plain``,
``ops/infercnv_kernel.py::pack_csr_plain`` / ``pack_columns_plain``, scipy for
the dense-to-CSR scan) and against the JAX package's native packer
(``infercnvpy_tpu.native``) on the same inputs; the bfloat16 rounding against
``ml_dtypes``.  Every comparison is exact (tolerance 0): each value is copied
or rounded once, with no arithmetic.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from infercnvpy_tpu_torch import native  # noqa: E402
from infercnvpy_tpu_torch.genome import build_window_plan  # noqa: E402
from infercnvpy_tpu_torch.ops import infercnv_kernel as tik  # noqa: E402
from infercnvpy_tpu_torch.ops import sparse_ingest as tsi  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _plan(n_genes=500, seed=0):
    rng = np.random.default_rng(seed)
    var = pd.DataFrame({
        "chromosome": rng.choice([f"chr{i}" for i in range(1, 6)], size=n_genes),
        "start": rng.integers(0, 10_000_000, size=n_genes),
    })
    var["end"] = var["start"] + 100
    return build_window_plan(var, window_size=25, step=5)


def _csr(n_rows=64, n_cols=500, density=0.1, seed=2, dtype=np.float32):
    x = sp.random(n_rows, n_cols, density=density, format="csr", dtype=np.float64, random_state=seed)
    x.data = (x.data * 10 - 5).astype(dtype)
    x = x.astype(dtype)
    if n_rows > 3:
        x = x.tolil()
        x[3, :] = 0  # an empty row
        x = x.tocsr()
        x.eliminate_zeros()
    return x


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pack_csr_matches_numpy_and_jax(dtype):
    from infercnvpy_tpu.native import native_pack_csr

    plan = _plan()
    x = _csr()
    lut = tik._pack_lut(plan, 500)
    width = tik.packed_width(plan)
    got = tik.pack_csr(x, plan, lut, dtype=dtype)
    want = tik.pack_csr_plain(x, plan, lut, dtype=dtype)
    jax_native = native_pack_csr(x.indptr, x.indices, x.data, lut, width, dtype)
    assert got.dtype == want.dtype == jax_native.dtype == np.dtype(dtype)
    npt.assert_array_equal(_bits(got), _bits(want))
    npt.assert_array_equal(_bits(got), _bits(jax_native))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pack_dense_matches_numpy_and_jax(dtype):
    from infercnvpy_tpu.native import native_pack_dense

    plan = _plan(seed=3)
    x = np.random.default_rng(4).normal(size=(32, 500)).astype(np.float32)
    x[:, ::3] = 0
    lut = tik._pack_lut(plan, 500)
    width = tik.packed_width(plan)
    got = tik.pack_columns(x, plan, lut, dtype=dtype)
    want = tik.pack_columns_plain(x, plan, lut, dtype=dtype)
    jax_native = native_pack_dense(x, lut, width, dtype)
    npt.assert_array_equal(_bits(got), _bits(want))
    npt.assert_array_equal(_bits(got), _bits(jax_native))


def test_row_ranges_and_out_buffers_are_overwritten():
    plan = _plan(seed=5)
    x = _csr(n_rows=40, seed=6)
    lut = tik._pack_lut(plan, 500)
    width = tik.packed_width(plan)
    want = tik.pack_csr_plain(x[7:29], plan, lut, dtype=np.float32)
    out = np.full((22, width), np.nan, np.float32)  # stale contents must not survive
    got = tik.pack_csr(x, plan, lut, dtype=np.float32, rows=(7, 29), out=out)
    assert got is out
    npt.assert_array_equal(_bits(got), _bits(want))

    dense = x.toarray()
    out = np.full((40, width), 7.0, np.float32)
    tik.pack_columns(dense, plan, lut, out=out)
    npt.assert_array_equal(out, tik.pack_columns_plain(dense, plan, lut))

    cap = x[7:29].nnz + 50
    cols = np.full(cap, 123, np.uint16)
    vals = np.full(cap, np.nan, np.float32)
    counts = np.full(22, -1, np.int32)
    got = tsi.coo_from_csr_batch(x, lut, width, cap, rows=(7, 29), out=(cols, vals, counts))
    want = tsi.coo_from_csr_batch_plain(x[7:29], lut, width, cap)
    assert got[0] is cols and got[1] is vals and got[2] is counts and got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        npt.assert_array_equal(_bits(g), _bits(w))
    with pytest.raises(ValueError, match="C-contiguous float32"):
        tik.pack_csr(x, plan, lut, dtype=np.float32, out=np.zeros((40, width + 1), np.float32))


@pytest.mark.parametrize("width", [410, 70_000], ids=["uint16_cols", "int32_cols"])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("val_dtype", [np.float32, np.float64])
def test_coo_remap_matches_numpy_and_jax(width, filtered, val_dtype):
    from infercnvpy_tpu.native import native_coo_remap

    rng = np.random.default_rng(9)
    x = _csr(n_rows=70, n_cols=400, density=0.15, seed=8)
    lut = np.full(400, -1, np.int64)
    kept = 300 if filtered else 400
    used = rng.choice(400, size=kept, replace=False)
    lut[used] = rng.choice(width, size=kept, replace=False)
    cap = tsi.round_nnz_cap(x.nnz)
    col_dtype = tsi.col_index_dtype(width)
    assert np.dtype(col_dtype) == (np.uint16 if width == 410 else np.int32)
    got = tsi.coo_from_csr_batch(x, lut, width, cap, val_dtype=val_dtype)
    want = tsi.coo_from_csr_batch_plain(x, lut, width, cap, val_dtype=val_dtype)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        npt.assert_array_equal(_bits(g), _bits(w))
    if val_dtype == np.float32:
        cols, vals, counts, nnz = native_coo_remap(x.indptr, x.indices, x.data, lut, cap, col_dtype, np.float32)
        assert nnz == got[3]
        npt.assert_array_equal(counts, got[2])
        npt.assert_array_equal(cols[:nnz], got[0][:nnz])
        npt.assert_array_equal(_bits(vals[:nnz]), _bits(got[1][:nnz]))


def _bf16_inputs():
    rng = np.random.default_rng(11)
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 3.0e38, -3.4e38, 1e-40, -1e-45, 1.00390625,
                        1.01171875, 65504.0], np.float32)
    special[1] = np.uint32(0xFFAB0001).view(np.float32)  # a negative NaN with a payload
    special[0] = np.uint32(0x7FAB0001).view(np.float32)
    return np.concatenate([special, (rng.standard_normal(5000) * 10.0 ** rng.integers(-30, 30, 5000)).astype(np.float32)])


def test_coo_remap_bf16_bits_match_ml_dtypes_and_jax():
    import ml_dtypes

    from infercnvpy_tpu.native import native_coo_remap

    data = _bf16_inputs()
    n = len(data)
    x = sp.csr_matrix((data, np.arange(n, dtype=np.int32) % 50, np.array([0, n // 2, n], np.int64)), shape=(2, 50))
    lut = np.arange(50, dtype=np.int64)
    cols, vals, counts, nnz = tsi.coo_from_csr_batch(x, lut, 50, n + 10, val_dtype="bfloat16")
    assert nnz == n and vals.dtype == np.uint16 and not vals[n:].any()
    with np.errstate(invalid="ignore"):  # ml_dtypes warns on casting NaN
        npt.assert_array_equal(vals[:n], data.astype(ml_dtypes.bfloat16).view(np.uint16))
    jax_vals = native_coo_remap(x.indptr, x.indices, x.data, lut, n + 10, np.uint16, np.dtype(ml_dtypes.bfloat16))[1]
    npt.assert_array_equal(vals[:n], jax_vals[:n].view(np.uint16))


def test_torch_bf16_rounding_matches_native_on_finite_values():
    """The dense host-pack path rounds with torch, the sparse one in pack.cpp:
    the same bits wherever the input is finite; a NaN stays a NaN (torch may
    give it another payload or sign)."""
    data = _bf16_inputs()
    x = sp.csr_matrix(data[None, :])
    native_bits = tsi.coo_from_csr_batch(x, np.arange(len(data), dtype=np.int64), len(data),
                                         val_dtype="bfloat16")[1]
    native_bits = native_bits[np.argsort(x.indices, kind="stable")]
    dense = data[x.indices[np.argsort(x.indices, kind="stable")]]
    torch_bits = torch.from_numpy(dense).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    fin = np.isfinite(dense)
    npt.assert_array_equal(torch_bits[fin], native_bits[fin])
    as_float = torch.from_numpy(torch_bits.view(np.int16)).view(torch.bfloat16).float().numpy()
    npt.assert_array_equal(np.isnan(as_float), np.isnan(dense))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dense_to_csr_matches_scipy_and_jax(dtype):
    from infercnvpy_tpu.native import native_dense_to_csr

    d = np.random.default_rng(7).normal(size=(60, 45)).astype(dtype)
    d[np.abs(d) < 0.8] = 0.0
    d[5] = 0.0
    d[6, 2] = -0.0
    d[7, 3] = np.nan
    data, indices, indptr = native.dense_to_csr(d)
    assert indptr.dtype == indices.dtype == np.int32 and data.dtype == np.dtype(dtype)
    want = sp.csr_matrix(d)
    npt.assert_array_equal(indptr, want.indptr)
    npt.assert_array_equal(indices, want.indices)
    npt.assert_array_equal(_bits(data), _bits(want.data))
    if dtype == np.float32:
        for g, w in zip((data, indices, indptr), native_dense_to_csr(d)):
            npt.assert_array_equal(_bits(g), _bits(w))


def test_nnz_cap_too_small_raises():
    from infercnvpy_tpu.native import native_coo_remap

    x = sp.random(10, 50, density=0.5, format="csr", dtype=np.float32, random_state=0)
    lut = np.arange(50, dtype=np.int64)
    with pytest.raises(ValueError, match="too small") as got:
        tsi.coo_from_csr_batch(x, lut, 50, 3)
    with pytest.raises(ValueError, match="too small") as want:
        native_coo_remap(x.indptr, x.indices, x.data, lut, 3, np.uint16, np.float32)
    with pytest.raises(ValueError, match="too small") as plain:
        tsi.coo_from_csr_batch_plain(x, lut, 50, 3)
    assert str(got.value) == str(want.value) == str(plain.value)


def test_out_of_range_indices_raise():
    plan = _plan(seed=9)
    width = tik.packed_width(plan)
    lut = tik._pack_lut(plan, 500)
    x = _csr(n_rows=8, seed=10)
    bad = x.copy()
    bad.indices = bad.indices.copy()
    bad.indices[0] = 600
    with pytest.raises(IndexError, match="out of range"):
        native.pack_csr(bad.indptr, bad.indices, bad.data, lut, width)
    with pytest.raises(IndexError, match="out of range"):
        tsi.coo_from_csr_batch(bad, lut, width, 10_000)
    bad_lut = lut.copy()
    bad_lut[0] = width + 5
    with pytest.raises(IndexError, match="out_width"):
        native.pack_csr(x.indptr, x.indices, x.data, bad_lut, width)
    with pytest.raises(IndexError, match="out_width"):
        native.pack_dense(np.zeros((4, 500), np.float32), bad_lut, width)
    with pytest.raises(IndexError, match="shorter"):
        native.pack_dense(np.zeros((4, 500), np.float32), lut[:100], width)
    with pytest.raises(TypeError, match="float32 or float64"):
        native.pack_dense(np.zeros((4, 500), np.int32), lut, width)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "pack.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build()
    assert "pack.cpp" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_is_built_under_a_source_hash():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libinfercnv_pack-")
    assert native.build() == path  # an unchanged source loads the existing library


@pytest.mark.parametrize(
    "rep,kw,packer",
    [
        (sp.csr_matrix, {}, "coo_remap"),
        (sp.csr_matrix, {"device_densify": False}, "pack_csr"),
        (np.asarray, {}, "pack_dense"),
        (sp.csr_matrix, {"compress_results": False}, "dense_to_csr"),
        (sp.csr_matrix, {"window_size": 21, "step": 2}, "mask_to_csr"),
    ],
    ids=["sparse", "host_pack_csr", "dense", "dense_fetch", "packed"],
)
def test_infercnv_runs_the_native_packers(rep, kw, packer):
    import infercnvpy_tpu_torch as tcnv

    adata = tcnv.datasets.oligodendroglioma()
    adata.X = rep(adata.X.toarray())
    fn = getattr(native, packer)
    before = fn.calls
    tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat="Microglia/Macrophage", device="cpu",
                     batch_cells=5000, **kw)
    assert fn.calls > before
