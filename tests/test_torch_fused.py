"""The port's fused step and row median against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as ``tests/test_pallas.py`` runs them.
Cases marked ``cuda`` hold the CUDA kernels against the plain versions and
skip where no GPU is present.  They need neither JAX nor the JAX package, so
on a GPU machine without JAX they run with

    python -m pytest tests/test_torch_fused.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from infercnvpy_tpu_torch.genome import build_window_plan  # noqa: E402
from infercnvpy_tpu_torch.ops import fused as tf  # noqa: E402
from infercnvpy_tpu_torch.ops.infercnv_kernel import _pack_lut, pack_columns, small_offsets  # noqa: E402
from infercnvpy_tpu_torch.ops.select import row_median, row_median_cuda, row_median_plain  # noqa: E402

# the plans of tests/test_pallas.py::test_fused_pipeline_matches_unfused, plus
# one with no small chromosome and one with only small chromosomes
SPEC_MIXED = [150, 40, 7, 90]
FUSED_CASES = [
    (SPEC_MIXED, 100, 10, 2),
    (SPEC_MIXED, 9, 3, 1),
    (SPEC_MIXED, 11, 1, 3),
    ([150, 230, 120], 21, 3, 2),  # no small chromosome
    ([40, 7], 100, 10, 1),  # only small chromosomes (P = 0)
    ([120, 60], 30, 30, 2),  # window == step
]
FUSED_IDS = ["w100s10_nref2", "w9s3_nref1", "w11s1_nref3", "no_small", "only_small", "window_eq_step"]
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _var(counts):
    rows = [(f"chr{c + 1}", i * 100) for c, g in enumerate(counts) for i in range(g)]
    var = pd.DataFrame(rows, columns=["chromosome", "start"])
    var["end"] = var["start"] + 1
    return var


def _jax():
    """The JAX package's build_window_plan and fused kernel module (imported only where compared)."""
    from infercnvpy_tpu.genome import build_window_plan as jax_build_plan
    from infercnvpy_tpu.ops import pallas_fused

    return jax_build_plan, pallas_fused


def _inputs(counts, window, step, n_ref, n_cells=37, seed=0):
    """Packed x and (min, max) reference rows from one numpy seed, plus the port's plan and the var."""
    var = _var(counts)
    tplan = build_window_plan(var, window, step)
    rng = np.random.default_rng(seed)
    lut = _pack_lut(tplan, len(var))
    x = pack_columns(rng.normal(size=(n_cells, len(var))).astype(np.float32), tplan, lut)
    ref = pack_columns(rng.normal(size=(n_ref, len(var))).astype(np.float32), tplan, lut)
    ref2 = np.concatenate([ref, ref]) if n_ref == 1 else np.stack([ref.min(0), ref.max(0)])
    return var, tplan, x, ref2.astype(np.float32), min(n_ref, 2)


@pytest.mark.parametrize("counts,window,step,n_ref", FUSED_CASES, ids=FUSED_IDS)
def test_plain_fused_matches_jax_fused(counts, window, step, n_ref):
    import jax.numpy as jnp

    jax_build_plan, jpf = _jax()
    var, tplan, x, ref2, n_ref = _inputs(counts, window, step, n_ref)
    jplan = jax_build_plan(var, window, step)
    row_tile = 8
    pad = (-x.shape[0]) % row_tile
    xj = np.concatenate([x, np.zeros((pad, x.shape[1]), np.float32)])
    want = jpf.fused_center_smooth_median(
        jnp.asarray(xj), jnp.asarray(ref2), jplan, lfc_clip=1.0, n_ref=n_ref, row_tile=row_tile
    )
    want = [np.asarray(w)[: x.shape[0]] for w in want]
    got = tf.fused_center_smooth_median(torch.from_numpy(x), torch.from_numpy(ref2), tplan, lfc_clip=1.0, n_ref=n_ref)
    got = [g.numpy() for g in got]
    assert got[0].shape == (x.shape[0], tplan.n_windows)
    for g, w, name in zip(got, want, ["x_res", "row_sum", "row_sumsq", "median"]):
        assert g.dtype == np.float32, name
        # a row sum adds n_windows terms, each within the element bar
        atol = ATOL * tplan.n_windows if name.startswith("row_") else ATOL
        npt.assert_allclose(g, w, rtol=RTOL, atol=atol, err_msg=name)


@pytest.mark.parametrize("counts,window,step,n_ref", FUSED_CASES, ids=FUSED_IDS)
def test_host_tables_equal(counts, window, step, n_ref):
    jax_build_plan, jpf = _jax()
    var = _var(counts)
    jplan = jax_build_plan(var, window, step)
    tplan = build_window_plan(var, window, step)
    assert tf._conv_region_windows(tplan) == jpf._conv_region_windows(jplan)
    npt.assert_array_equal(tf.final_gather_map(tplan), jpf.final_gather_map(jplan))
    assert tf._assembly_runs(tplan) == jpf._assembly_runs(jplan)
    off = small_offsets(tplan)
    npt.assert_array_equal(np.diff(off), tplan.small_counts)
    # the tail slices hold exactly the small chromosomes' genes, in plan order
    lut = _pack_lut(tplan, len(var))
    npt.assert_array_equal(lut[tplan.small_src], np.arange(off[0], off[-1]))


def test_fused_rejects_bad_shapes():
    _, tplan, x, ref2, _ = _inputs(SPEC_MIXED, 100, 10, 2)
    with pytest.raises(ValueError, match="x must be"):
        tf.fused_center_smooth_median(torch.from_numpy(x[:, 1:]), torch.from_numpy(ref2), tplan, lfc_clip=1.0)
    with pytest.raises(ValueError, match="n_ref"):
        tf.fused_center_smooth_median(torch.from_numpy(x), torch.from_numpy(ref2), tplan, lfc_clip=1.0, n_ref=3)
    with pytest.raises(ValueError, match="CUDA"):
        tf.fused_center_smooth_median_cuda(torch.from_numpy(x), torch.from_numpy(ref2), tplan, lfc_clip=1.0)


def _median_input(shape, dtype=np.float32):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(dtype)
    x[0, :] = 0.0
    if shape[0] > 1:
        x[1, : shape[1] // 2] = -1.5
    return x


def _assert_median_equal(got: np.ndarray, want: np.ndarray):
    # exact equality of values, as tests/test_pallas.py checks the TPU kernel;
    # only the sign of a zero median may differ (np.median adds the two middle
    # values onto +0, so two -0 middles give +0 there and -0 here)
    npt.assert_array_equal(got, want)
    nonzero = want != 0
    npt.assert_array_equal(got[nonzero].view(np.uint8), want[nonzero].view(np.uint8))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(8, 9), (16, 1793), (8, 1794), (8, 2), (3, 1)])
def test_row_median_plain_matches_np_median(shape, dtype):
    x = _median_input(shape, dtype)
    got = row_median(torch.from_numpy(x)).numpy()
    assert got.dtype == dtype
    _assert_median_equal(got, np.median(x, axis=1).astype(dtype))


def test_row_median_negatives_and_ties():
    x = np.array(
        [
            [-1.0, -1.0, -1.0, 5.0],
            [0.0, -0.0, 1.0, -1.0],
            [np.float32(1e-38), np.float32(-1e-38), 2.0, -2.0],
            [-0.0, -0.0, 3.0, -3.0],
            [np.inf, -np.inf, 1.0, 2.0],
        ],
        dtype=np.float32,
    )
    got = row_median_plain(torch.from_numpy(x)).numpy()
    _assert_median_equal(got, np.median(x, axis=1).astype(np.float32))


def test_row_median_wide():
    x = np.random.default_rng(2).normal(size=(16, 20000)).astype(np.float32)
    _assert_median_equal(row_median(torch.from_numpy(x)).numpy(), np.median(x, axis=1).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("counts,window,step,n_ref", FUSED_CASES, ids=FUSED_IDS)
def test_fused_kernel_matches_plain_on_gpu(cuda, counts, window, step, n_ref):
    _, tplan, x, ref2, n_ref = _inputs(counts, window, step, n_ref, n_cells=300)
    xd, rd = torch.from_numpy(x).to(cuda), torch.from_numpy(ref2).to(cuda)
    before = tf.fused_center_smooth_median_cuda.launches
    got = tf.fused_center_smooth_median(xd, rd, tplan, lfc_clip=1.0, n_ref=n_ref)
    assert tf.fused_center_smooth_median_cuda.launches == before + 1
    want = tf.fused_center_smooth_median_plain(xd, rd, tplan, lfc_clip=1.0, n_ref=n_ref)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ["x_res", "row_sum", "row_sumsq", "median"]):
        atol = ATOL * tplan.n_windows if name.startswith("row_") else ATOL
        torch.testing.assert_close(g, w, rtol=RTOL, atol=atol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 9), (16, 1793), (8, 1794), (8, 2), (3, 1), (16, 20000)])
def test_row_median_kernel_bit_identical_on_gpu(cuda, shape):
    x = torch.from_numpy(_median_input(shape)).to(cuda)
    got = row_median_cuda(x)
    want = row_median_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# the shapes where the staged kernel can break: generic window / step, widths
# and row starts off 16 bytes, one row, the column-tiled path
EDGE_CASES = [
    ([700, 300, 90, 251], 250, 25, 2),
    ([150, 41, 7, 90], 40, 7, 2),
    ([150, 41, 7, 91], 100, 10, 1),
    ([1300, 40, 700], 100, 10, 2),
]
EDGE_IDS = ["w250s25", "w40s7", "w100s10_odd_width", "w100s10_wide"]


@pytest.mark.cuda
@pytest.mark.parametrize("tiled", [False, True], ids=["roomy", "squeezed"])
@pytest.mark.parametrize("rows", [1, 133])
@pytest.mark.parametrize("counts,window,step,n_ref", EDGE_CASES, ids=EDGE_IDS)
def test_fused_kernel_edges_on_gpu(cuda, counts, window, step, n_ref, rows, tiled):
    _, tplan, x, ref2, n_ref = _inputs(counts, window, step, n_ref, n_cells=rows + 1)
    # drop the first row: with a width off a multiple of 4 the rows then start off 16 bytes
    xd, rd = torch.from_numpy(x).to(cuda)[1:], torch.from_numpy(ref2).to(cuda)
    limit = None
    if tiled:
        # half of what the row in one tile needs: column tiles
        one = tf.stage_plan(tplan, 10**6, 10**6)
        limit = one["smem_bytes"] // 2
        assert tf.stage_plan(tplan, limit, limit)["n_tiles"] >= 2
    got = tf.fused_center_smooth_median_cuda(xd, rd, tplan, lfc_clip=1.0, n_ref=n_ref, smem_limit=limit)
    again = tf.fused_center_smooth_median_cuda(xd, rd, tplan, lfc_clip=1.0, n_ref=n_ref, smem_limit=limit)
    want = tf.fused_center_smooth_median_plain(xd, rd, tplan, lfc_clip=1.0, n_ref=n_ref)
    torch.cuda.synchronize()
    for g, a, w, name in zip(got, again, want, ["x_res", "row_sum", "row_sumsq", "median"]):
        atol = ATOL * tplan.n_windows if name.startswith("row_") else ATOL
        torch.testing.assert_close(g, w, rtol=RTOL, atol=atol, msg=name)
        assert torch.equal(g.view(torch.int32), a.view(torch.int32)), f"{name}: a rerun changed bits"


@pytest.mark.cuda
def test_fused_tables_are_cached_per_plan_and_cleared(cuda):
    from infercnvpy_tpu_torch.tl import clear_transform_caches

    _, tplan, x, ref2, n_ref = _inputs(SPEC_MIXED, 100, 10, 2, n_cells=4)
    xd, rd = torch.from_numpy(x).to(cuda), torch.from_numpy(ref2).to(cuda)
    clear_transform_caches()
    tf.fused_center_smooth_median_cuda(xd, rd, tplan, lfc_clip=1.0, n_ref=n_ref)
    assert len(tf._device_tables) == 1
    first = next(iter(tf._device_tables.values()))[2].data_ptr()
    tf.fused_center_smooth_median_cuda(xd, rd, build_window_plan(_var(SPEC_MIXED), 100, 10), lfc_clip=1.0, n_ref=n_ref)
    assert len(tf._device_tables) == 1 and next(iter(tf._device_tables.values()))[2].data_ptr() == first
    clear_transform_caches()
    assert not tf._device_tables


def _degenerate_rows(width):
    x = np.random.default_rng(width).normal(size=(64, width)).astype(np.float32)
    x[:16] = 0.75  # all equal
    x[16:32] = np.where(x[16:32] > 0, np.float32(1.5), np.float32(-2.0))  # two values
    x[32:40] = np.where(x[32:40] > 0, np.float32(0.0), np.float32(-0.0))
    x[40, :] = np.inf
    x[41, : width // 2] = -np.inf
    x[42] = x[42] * np.float32(1e-42)  # denormals
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 255, 256, 257, 1793, 1794, 2049, 5000])
def test_select_kernels_degenerate_rows_on_gpu(cuda, width):
    from infercnvpy_tpu_torch.ops import select as ts

    x = torch.from_numpy(_degenerate_rows(width)).to(cuda)
    pairs = [(row_median_cuda(x), row_median_plain(x))]
    for k in sorted({0, width // 2, width - 1}):
        pairs.append((ts.row_kth_smallest_cuda(x, k), ts.row_kth_smallest_plain(x, k)))
    rng = np.random.default_rng(1)
    for parity in (0, 1):
        wts = rng.integers(0, 9, size=width)
        wts[0] += 1
        wts[0] += (int(wts.sum()) + parity) % 2
        pairs.append((ts.row_median_weighted_cuda(x, wts), ts.row_median_weighted_plain(x, wts)))
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(pairs):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), f"select {i} at width {width}"
