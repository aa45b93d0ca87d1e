"""The new kernels' algorithms, in their Python transcriptions, on the CPU.

The CUDA sources cannot run here, so their arithmetic is kept in Python beside
them: ``ops.select.radix_select_emulated`` repeats the radix select of
``csrc/select.cuh`` (digits, histograms, bin scan, the two ranks of an even
total, weights), ``ops.select.warp_select_emulated`` / ``warp_row_walk`` /
``persistent_grid`` / ``select_variant`` the warp-a-row select of
``csrc/warp_select.cuh`` (lane layout, grouped adds, the rows of each warp,
the width that picks it), ``ops.fused.window_tasks`` / ``stage_plan`` /
``staged_windows_emulated`` the task table, tiling and indexing of
``csrc/fused_window.cu``, and ``ops.gene.packed_gidx`` the index tables of
``csrc/gene_project.cu``.  Here they are held, bit for bit where the kernels
are, against the key-sort plain versions, ``np.median(np.repeat(...))``,
``final_gather_map`` and the plain window stage.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from infercnvpy_tpu_torch.genome import build_window_plan  # noqa: E402
from infercnvpy_tpu_torch.ops import fused as tf  # noqa: E402
from infercnvpy_tpu_torch.ops import select as ts  # noqa: E402
from infercnvpy_tpu_torch.ops.gene import gene_projection_data, packed_gidx, unpack_gidx  # noqa: E402
from infercnvpy_tpu_torch.ops.infercnv_kernel import (  # noqa: E402
    _pack_lut,
    center,
    pack_columns,
    packed_width,
    smooth_packed,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _median_emulated(x, weights=None):
    total = x.shape[1] if weights is None else int(np.sum(weights))
    lo, hi = ts.radix_select_emulated(x, weights, *ts.median_ranks(total))
    return hi if total % 2 else (lo + hi) / np.float32(2)


SPECIAL = np.array(
    [
        [-1.0, -1.0, -1.0, 5.0, 2.0, 2.0],
        [0.0, -0.0, 1.0, -1.0, 0.0, -0.0],
        [1e-38, -1e-38, 2.0, -2.0, 1e-45, -1e-45],
        [-0.0, -0.0, 3.0, -3.0, 0.0, 0.0],
        [np.inf, -np.inf, 1.0, 2.0, np.inf, -np.inf],
        [7.0, 7.0, 7.0, 7.0, 7.0, 7.0],
        # the two middle elements differ in their first digit (sign), second, third and last
        [-1.0, -2.0, -3.0, 1.0, 2.0, 3.0],
        [1.0, 1.0, 1.0, 1.5, 1.5, 1.5],
        [1.0, 1.0, 1.0, 1.0001, 1.0001, 1.0001],
        [1.0, 1.0, 1.0, np.nextafter(np.float32(1), np.float32(2)), 2.0, 2.0],
    ],
    dtype=np.float32,
)


@pytest.mark.parametrize("width", [1, 2, 3, 9, 10, 255, 256, 257, 1793, 1794])
def test_radix_median_matches_key_sort(width):
    rng = np.random.default_rng(width)
    x = rng.normal(size=(12, width)).astype(np.float32)
    x[0, :] = 0.25  # all equal
    x[1, : width // 2] = -1.5  # ties across the median
    x[2] = np.round(x[2] * 4) / 4
    want = ts.row_median_plain(torch.from_numpy(x)).numpy()
    npt.assert_array_equal(_bits(_median_emulated(x)), _bits(want))


@pytest.mark.parametrize("cols", [6, 5, 4, 1])
def test_radix_median_special_values(cols):
    x = np.ascontiguousarray(SPECIAL[:, :cols])
    want = ts.row_median_plain(torch.from_numpy(x)).numpy()
    npt.assert_array_equal(_bits(_median_emulated(x)), _bits(want))


@pytest.mark.parametrize("k", [0, 1, 896, 1791, 1792])
def test_radix_kth_matches_key_sort(k):
    x = np.random.default_rng(k).normal(size=(8, 1793)).astype(np.float32)
    x[0] = np.round(x[0])
    lo, hi = ts.radix_select_emulated(x, None, k, k)
    want = ts.row_kth_smallest_plain(torch.from_numpy(x), k).numpy()
    npt.assert_array_equal(_bits(hi), _bits(want))
    npt.assert_array_equal(_bits(lo), _bits(want))


def _weights_cases(w, rng):
    ones = np.ones(w, np.int64)
    some = rng.integers(0, 12, size=w)
    some[rng.integers(0, w)] += 1 + (int(some.sum()) == 0)
    odd = some.copy()
    odd[np.flatnonzero(odd)[0]] += 1
    single = np.zeros(w, np.int64)
    single[w // 2] = 3
    return {"ones": ones, "mixed": some, "other_parity": odd, "one_live_column": single}


@pytest.mark.parametrize("width", [1, 2, 7, 64, 300, 1991])
@pytest.mark.parametrize("case", ["ones", "mixed", "other_parity", "one_live_column"])
def test_radix_weighted_median_matches_repeat_and_key_sort(width, case):
    rng = np.random.default_rng(width * 7 + len(case))
    wts = _weights_cases(width, rng)[case]
    x = rng.normal(size=(6, width)).astype(np.float32)
    x[0] = 1.0
    x[1] = np.round(x[1] * 2) / 2
    got = _median_emulated(x, wts)
    want = ts.row_median_weighted_plain(torch.from_numpy(x), wts).numpy()
    npt.assert_array_equal(_bits(got), _bits(want))
    ref = np.stack([np.median(np.repeat(r, wts)) for r in x]).astype(np.float32)
    npt.assert_array_equal(got, ref)


def test_radix_weighted_special_values_and_zero_weights():
    wts = np.array([2, 0, 1, 3, 0, 2])
    want = ts.row_median_weighted_plain(torch.from_numpy(SPECIAL), wts).numpy()
    npt.assert_array_equal(_bits(_median_emulated(SPECIAL, wts)), _bits(want))


def test_radix_rank_beyond_total_raises():
    with pytest.raises(ValueError, match="rank beyond"):
        ts.radix_select_emulated(np.zeros((1, 4), np.float32), [1, 0, 1, 0], 1, 2)


@settings(max_examples=60, deadline=None)
@given(
    width=st.integers(1, 300),
    seed=st.integers(0, 2**31 - 1),
    levels=st.sampled_from([0, 2, 16]),
    weighted=st.booleans(),
)
def test_radix_select_property(width, seed, levels, weighted):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, width)).astype(np.float32)
    if levels:
        x = (np.round(x * levels) / levels).astype(np.float32)
    if weighted:
        wts = rng.integers(0, 5, size=width)
        wts[rng.integers(0, width)] += 1
        want = ts.row_median_weighted_plain(torch.from_numpy(x), wts).numpy()
        got = _median_emulated(x, wts)
    else:
        want = ts.row_median_plain(torch.from_numpy(x)).numpy()
        got = _median_emulated(x)
    npt.assert_array_equal(_bits(got), _bits(want))


# ----- the warp-a-row select of K2 / K5 --------------------------------------


def _warp_median(x):
    w = x.shape[1]
    lo, hi = ts.warp_select_emulated(x, *ts.median_ranks(w))
    with np.errstate(invalid="ignore"):  # -inf and +inf in the middle: NaN, as in the plain version
        return hi if w % 2 else (lo + hi) / np.float32(2)


def test_warp_constants_match_the_cuda_sources():
    from infercnvpy_tpu_torch.ops import _build

    warp = (_build.CSRC / "warp_select.cuh").read_text()
    assert f"constexpr int kWarpMaxKeys = {ts.WARP_MAX_KEYS};" in warp
    assert "constexpr int kWarpMaxWidth = 32 * kWarpMaxKeys;" in warp
    assert "constexpr int kWarpStage = kWarpMaxWidth + 4;" in warp and ts.WARP_STAGE == ts.WARP_MAX_WIDTH + 4
    assert f"constexpr int kRadixBits = {ts.RADIX_BITS};" in (_build.CSRC / "select.cuh").read_text()
    for src in ("row_median.cu", "row_select.cu"):  # one instantiation of 64 keys a lane at every width
        assert "warp_select_rows<kWarpMaxKeys," in (_build.CSRC / src).read_text()
    assert f"constexpr int kWarpsPerBlock = {ts.WARPS};" in warp
    assert f"constexpr int kCopies = {ts.WARP_COPIES};" in warp
    assert ts.WARP_MAX_WIDTH == 2048 and 1 <= ts.WARPS <= 12
    # the weighted select: its list's (key, weight) pairs, the 16-bit weight table's limit, one instantiation of 64
    # slots
    assert "constexpr int kWScratch = kCopies * kCopyStride;" in warp
    assert "constexpr int kListPairs = (kWScratch - kBins) / 2;" in warp and ts.WARP_LIST_PAIRS == 392
    row_select = (_build.CSRC / "row_select.cu").read_text()
    assert f"wide = total > {ts.WARP_NARROW_TOTAL:#X}".replace("0X", "0x") in row_select
    assert ts.WARP_NARROW_TOTAL == 0xFFFF and "warp_weighted_median_rows<kWarpMaxKeys," in row_select


@pytest.mark.parametrize("width,variant", [(1, "warp"), (512, "warp"), (513, "warp"), (1793, "warp"), (1794, "warp"),
                                           (2048, "warp"), (2049, "block"), (5000, "block"), (20_000, "block")])
def test_select_variant_threshold(width, variant):
    assert ts.select_variant(width) == variant


@pytest.mark.parametrize("width", list(range(1, 70)) + [511, 512, 513, 1792, 1793, 1794, 2047, 2048])
def test_lane_slots_hold_each_value_once(width):
    mine = ts.lane_slots(width)
    held = np.concatenate([j * 32 + lane for lane, m in enumerate(mine) for j in [np.arange(m)]])
    npt.assert_array_equal(np.sort(held), np.arange(width))
    assert mine.max() <= ts.WARP_MAX_KEYS


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 6, 7, 8, 31, 1793, 1794, 1795, 1796, 2047, 2048])
def test_row_stage_covers_each_value_once(width):
    """Rows of a row-major (rows, width) tensor start 0-3 floats past 16 bytes; the peel and the bulk copy cover each."""
    for row in range(8):
        offset = row * width  # floats from the tensor's start, which is 16-byte aligned
        m, head, body = ts.row_stage_split(offset, width)
        tail = width - head - body
        assert 0 <= head <= 3 and 0 <= tail <= 3 and body % 4 == 0 and body >= 0
        if body:  # the copy starts and ends on 16 bytes, in device memory and in the stage
            assert (offset + head) % 4 == 0 and (offset + head + body) % 4 == 0 and (m + head) % 4 == 0
        # lanes 0 .. head-1 load the head, lanes 4 .. 4+tail-1 the tail, the copy the body
        by_lane = [lane for lane in range(head)] + [head + body + (lane - 4) for lane in range(4, 4 + tail)]
        covered = np.concatenate([np.array(by_lane, np.int64), head + np.arange(body)])
        npt.assert_array_equal(np.sort(covered), np.arange(width))
        assert m + width <= ts.WARP_STAGE and m == offset % 4
        # the stage read back by the lanes' slots is the row
        row_vals = np.arange(width, dtype=np.float32) + 100 * row
        stage = np.full(ts.WARP_STAGE, np.nan, np.float32)
        stage[m + covered] = row_vals[covered]
        got = stage[m + np.minimum(np.arange(ts.WARP_MAX_KEYS)[:, None] * 32 + np.arange(32)[None, :], width - 1)]
        npt.assert_array_equal(got.reshape(-1)[:width], row_vals)


@pytest.mark.parametrize("rows", [1, 133, 16_384])
@pytest.mark.parametrize("warps", [1, 4, 12])
def test_warp_row_walk_covers_every_row_once(rows, warps):
    # the card's grid (132 SMs, 1-4 blocks an SM) and grids larger than the rows need
    grids = {ts.persistent_grid(rows, warps, 132, per_sm) for per_sm in (1, 2, 4)} | {rows, rows + 7, 3 * rows}
    for grid in sorted(grids):
        walk = ts.warp_row_walk(grid, warps, rows)
        assert len(walk) == grid * warps
        seen = np.concatenate(walk)
        npt.assert_array_equal(np.sort(seen), np.arange(rows))
        assert max(len(r) for r in walk) == -(-rows // (grid * warps))


@pytest.mark.parametrize("rows,warps,sms,per_sm,grid", [
    (16_384, 8, 132, 2, 264), (16_384, 8, 132, 1, 132), (133, 8, 132, 2, 17), (1, 8, 132, 2, 1),
    (16_384, 4, 132, 3, 396), (16_384, 12, 132, 1, 132), (0, 8, 132, 2, 1),
])
def test_persistent_grid(rows, warps, sms, per_sm, grid):
    assert ts.persistent_grid(rows, warps, sms, per_sm) == grid


@pytest.mark.parametrize("width", [1, 2, 3, 31, 32, 33, 255, 511, 512, 513, 1793, 1794, 2047, 2048])
def test_warp_median_matches_key_sort(width):
    rng = np.random.default_rng(width)
    x = rng.normal(size=(12, width)).astype(np.float32)
    x[0, :] = 0.25  # all equal: every lane of every key position on one slot
    x[1, : width // 2] = -1.5
    x[2] = np.round(x[2] * 4) / 4
    x[3] *= np.float32(1e-42)  # denormals
    x[4, ::2] = -0.0
    x[5, : width // 3] = np.inf
    x[6, : width // 2] = -np.inf  # the top digits 0 and 255: a span of all 256 bins at an even width
    x[6, width // 2 :] = np.inf
    want = _bits(ts.row_median_plain(torch.from_numpy(x)).numpy())
    npt.assert_array_equal(_bits(_warp_median(x)), want)


@pytest.mark.parametrize("cols", [6, 5, 4, 1])
def test_warp_median_special_values(cols):
    x = np.ascontiguousarray(SPECIAL[:, :cols])
    want = ts.row_median_plain(torch.from_numpy(x)).numpy()
    npt.assert_array_equal(_bits(_warp_median(x)), _bits(want))


@pytest.mark.parametrize("k", [0, 1, 31, 32, 896, 1791, 1792])
def test_warp_kth_matches_key_sort(k):
    x = np.random.default_rng(k).normal(size=(8, 1793)).astype(np.float32)
    x[0] = np.round(x[0])
    x[1] = 3.0
    lo, hi = ts.warp_select_emulated(x, k, k)
    want = _bits(ts.row_kth_smallest_plain(torch.from_numpy(x), k).numpy())
    npt.assert_array_equal(_bits(hi), want)
    npt.assert_array_equal(_bits(lo), want)


def test_warp_select_refuses_a_row_wider_than_the_warp():
    with pytest.raises(ValueError, match="a warp holds"):
        ts.warp_select_emulated(np.zeros((1, ts.WARP_MAX_WIDTH + 1), np.float32), 0, 0)
    with pytest.raises(ValueError, match="rank_lo or rank_lo"):
        ts.warp_select_emulated(np.zeros((1, 8), np.float32), 2, 4)


@settings(max_examples=60, deadline=None)
@given(
    width=st.integers(1, 600),
    seed=st.integers(0, 2**31 - 1),
    levels=st.sampled_from([0, 2, 16]),
    kth=st.booleans(),
)
def test_warp_select_property(width, seed, levels, kth):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, width)).astype(np.float32)
    if levels:
        x = (np.round(x * levels) / levels).astype(np.float32)
    if kth:
        k = int(rng.integers(0, width))
        got = ts.warp_select_emulated(x, k, k)[1]
        want = ts.row_kth_smallest_plain(torch.from_numpy(x), k).numpy()
    else:
        got = _warp_median(x)
        want = ts.row_median_plain(torch.from_numpy(x)).numpy()
    npt.assert_array_equal(_bits(got), _bits(want))


# ----- the weighted warp-a-row select of K4 -----------------------------------


def _warp_wmedian(x, wts):
    total = int(np.sum(wts))
    lo, hi = ts.warp_select_emulated(x, *ts.median_ranks(total), weights=wts)
    with np.errstate(invalid="ignore"):  # -inf and +inf in the middle: NaN, as in the plain version
        return hi if total % 2 else (lo + hi) / np.float32(2)


def _jax_wmedian(x, wts):
    """The JAX package's K4 in Pallas interpret mode, as tests/test_torch_gene.py runs it."""
    from infercnvpy_tpu.ops.pallas_select import row_median_weighted as jax_wmedian

    return np.asarray(jax_wmedian(x, np.asarray(wts, np.int32), row_tile=8))


def _assert_wmedian(x, wts, jax=True):
    """The warp routine bit for bit against the key sort, ``np.median(np.repeat(...))`` and (``jax``) the JAX kernel."""
    got = _warp_wmedian(x, wts)
    want = ts.row_median_weighted_plain(torch.from_numpy(x), wts).numpy()
    npt.assert_array_equal(_bits(got), _bits(want))
    npt.assert_array_equal(got, np.stack([np.median(np.repeat(r, wts)) for r in x]).astype(np.float32))
    if jax:
        npt.assert_array_equal(_bits(got), _bits(_jax_wmedian(x, wts)))


def _wmedian_rows(width, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(8, width)).astype(np.float32)
    x[0, :] = 0.25  # all equal: every chosen key in one bin (past the list's room at 2,048 columns)
    x[1, : width // 2] = -1.5  # half the row one key: a duplicated middle
    x[2] = np.round(x[2] * 4) / 4
    x[3] = np.round(x[3] * 8) / 8  # the eighths of chip_smoke.py's tied rows
    x[4, ::2] = -0.0
    x[5] = np.where(x[5] > 0, np.float32(1.5), np.float32(-2.0))
    return x


def _warp_weight_cases(width, rng):
    """Equal weights (the bench plan's 10), uneven 0-64 with ~10 % zeros, one live column, and past 16 bits."""
    uneven = rng.integers(1, 65, size=width)
    uneven[rng.random(width) < 0.1] = 0
    uneven[rng.integers(0, width)] += 1
    single = np.zeros(width, np.int64)
    single[width // 3] = 5
    big = rng.integers(0, 4, size=width)
    big[rng.integers(0, width)] = 70_000
    return {"equal": np.full(width, 10), "uneven": uneven, "one_live_column": single, "past_16_bits": big}


@pytest.mark.parametrize("width", [1, 2, 33, 1991, 2047, 2048])
@pytest.mark.parametrize("case", ["equal", "uneven", "one_live_column", "past_16_bits"])
@pytest.mark.parametrize("total", ["even", "odd"])
def test_warp_weighted_median_matches_key_sort_and_jax(width, case, total):
    rng = np.random.default_rng(width * 31 + len(case))
    wts = _warp_weight_cases(width, rng)[case].astype(np.int64)
    if int(wts.sum()) % 2 != (total == "odd"):
        wts[np.flatnonzero(wts)[0]] += 1
    assert int(wts.sum()) % 2 == (total == "odd")
    _assert_wmedian(_wmedian_rows(width, width), wts)


@pytest.mark.parametrize("total", ["even", "odd"])
def test_warp_weighted_median_duplicated_middle_key(total):
    """An even total whose upper middle key is duplicated: the lower middle is that key again (and the reverse)."""
    x = np.array([[1.0, 2.0, 2.0, 3.0, -0.0, 0.0], [5.0, 5.0, 5.0, -1.0, 7.0, 7.0], [2.0, 2.0, 2.0, 2.0, 1.0, 3.0]],
                 np.float32)
    wts = np.array([1, 2, 1, 1, 0, 1] if total == "even" else [1, 2, 1, 1, 0, 2])
    _assert_wmedian(x, wts)


@pytest.mark.parametrize("width", [2, 33, 1991, 2048])
def test_warp_weighted_median_zero_weights_on_the_middle_keys(width):
    """The columns that hold the unweighted middle ranks weigh 0: the median moves to their neighbours."""
    x = np.random.default_rng(width).normal(size=(4, width)).astype(np.float32)
    x[1] = np.round(x[1] * 4) / 4
    x[2, :] = 0.5
    x[2, : width // 2] = -0.5
    for r in range(len(x)):
        wts = np.random.default_rng(r).integers(1, 9, size=width)
        order = np.argsort(x[r], kind="stable")
        mid = order[max(width // 2 - 2, 0) : width // 2 + 2]
        wts[mid] = 0
        if not wts.any():
            wts[order[-1]] = 1
        for parity in (0, 1):
            w2 = wts.copy()
            w2[np.flatnonzero(w2)[0]] += (int(w2.sum()) + parity) % 2
            _assert_wmedian(x[r : r + 1], w2)


@pytest.mark.parametrize("cols", [6, 5, 4, 1])
def test_warp_weighted_median_special_values(cols):
    x = np.ascontiguousarray(SPECIAL[:, :cols])
    for wts in ([2, 0, 1, 3, 0, 2], [1, 1, 1, 1, 1, 1], [0, 3, 0, 0, 1, 0], [70_000, 1, 2, 0, 5, 69_999]):
        wts = np.asarray(wts[:cols])
        if not wts.any():
            continue
        got = _warp_wmedian(x, wts)
        npt.assert_array_equal(_bits(got), _bits(ts.row_median_weighted_plain(torch.from_numpy(x), wts).numpy()))


def test_warp_weighted_list_room():
    """The weighted list's (key, weight) pairs and histogram fit the first pass's copies; a row of one key chooses
    every column, more than the list holds."""
    assert 2 * ts.WARP_LIST_PAIRS + 256 <= ts.WARP_COPIES * (256 + 4)
    x = np.full((1, ts.WARP_MAX_WIDTH), 3.0, np.float32)
    wts = np.arange(ts.WARP_MAX_WIDTH) % 3
    assert ts.WARP_MAX_WIDTH > ts.WARP_LIST_PAIRS
    _assert_wmedian(x, wts, jax=False)
    with pytest.raises(ValueError, match="rank beyond"):
        ts.warp_select_emulated(x, 0, 1, weights=np.zeros(ts.WARP_MAX_WIDTH, np.int64))


@settings(max_examples=60, deadline=None)
@given(
    width=st.integers(1, 2048),
    seed=st.integers(0, 2**31 - 1),
    levels=st.sampled_from([0, 2, 16]),
    largest=st.sampled_from([1, 8, 64, 70_000]),
    zeros=st.sampled_from([0.0, 0.1, 0.9]),
)
def test_warp_weighted_select_property(width, seed, levels, largest, zeros):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, width)).astype(np.float32)
    if levels:
        x = (np.round(x * levels) / levels).astype(np.float32)
    wts = rng.integers(0, largest + 1, size=width)
    wts[rng.random(width) < zeros] = 0
    wts[rng.integers(0, width)] += 1
    _assert_wmedian(x, wts, jax=False)


# ----- the fused kernel's host tables ---------------------------------------

PLANS = {
    "w100s10_mixed": ([150, 40, 7, 90, 333], 100, 10),
    "w9s3": ([150, 40, 7, 90], 9, 3),
    "w11s1": ([150, 40, 7, 90], 11, 1),
    "w21s3_no_small": ([150, 230, 120], 21, 3),
    "only_small": ([40, 7], 100, 10),
    "window_eq_step": ([120, 60], 30, 30),
    "w250s25": ([700, 300, 90, 251], 250, 25),
    "w40s7": ([150, 41, 7, 90], 40, 7),
}


def _var(counts):
    rows = [(f"chr{c + 1}", i * 100) for c, g in enumerate(counts) for i in range(g)]
    var = pd.DataFrame(rows, columns=["chromosome", "start"])
    var["end"] = var["start"] + 1
    return var


def _plan(name):
    counts, window, step = PLANS[name]
    return _var(counts), build_window_plan(_var(counts), window, step)


@pytest.mark.parametrize("name", list(PLANS))
def test_window_tasks_cover_the_gather_map(name):
    _, plan = _plan(name)
    tasks = tf.window_tasks(plan)
    gmap = tf.final_gather_map(plan)
    P = tf._conv_region_windows(plan)
    seen = np.full(plan.n_windows, -1, np.int64)
    regular = tasks[tasks[:, 2] >= 0]
    # regular tasks first, sorted by conv position; then the small-chromosome tasks
    assert (tasks[: len(regular), 2] >= 0).all() and (np.diff(regular[:, 1]) >= 0).all()
    assert len(tasks) - len(regular) == plan.n_windows - plan.n_reg_windows
    for k_first, a, z, b in tasks:
        if z < 0:
            assert seen[k_first] == -1
            seen[k_first] = gmap[k_first]
            off = tf.small_offsets(plan)
            j = gmap[k_first] - P
            assert (a, b) == (off[j], off[j + 1])
            continue
        j0, j1 = z & 0xFF, z >> 8
        assert a % tf.GROUP == 0 and 0 <= j0 < j1 <= tf.GROUP and b == 0
        for j in range(j0, j1):
            k = k_first + j - j0
            assert seen[k] == -1 and a + j < P
            seen[k] = a + j
    npt.assert_array_equal(seen, gmap)
    # a run of the map needs at most ceil(len / 4) + 1 aligned groups
    runs = tf._assembly_runs(plan)
    bound = sum(-(-ln // tf.GROUP) + 1 if src < P else ln for src, ln in runs)
    assert len(tasks) <= bound


def test_window_tasks_agree_with_the_jax_runs():
    from infercnvpy_tpu.genome import build_window_plan as jax_build_plan
    from infercnvpy_tpu.ops import pallas_fused as jpf

    for name, (counts, window, step) in PLANS.items():
        var = _var(counts)
        plan = build_window_plan(var, window, step)
        jruns = jpf._assembly_runs(jax_build_plan(var, window, step))
        # rebuild the runs from the tasks: consecutive sources in window order
        src = np.empty(plan.n_windows, np.int64)
        P = tf._conv_region_windows(plan)
        off = tf.small_offsets(plan)
        for k_first, a, z, b in tf.window_tasks(plan):
            if z < 0:
                src[k_first] = P + int(np.searchsorted(off, a))
            else:
                j0, j1 = z & 0xFF, z >> 8
                src[k_first : k_first + j1 - j0] = a + np.arange(j0, j1)
        cuts = np.flatnonzero(np.diff(src) != 1) + 1
        starts = np.concatenate([[0], cuts])
        ends = np.concatenate([cuts, [len(src)]])
        assert [(int(src[s]), int(e - s)) for s, e in zip(starts, ends)] == jruns, name


@pytest.mark.parametrize("name", list(PLANS))
def test_pyramid_weights_are_the_plan_pyramid(name):
    _, plan = _plan(name)
    w = tf.pyramid_weights(plan)
    assert w.dtype == np.float32 and float(w.sum()) == plan.pyramid_sum
    npt.assert_allclose(w / plan.pyramid_sum, plan.pyramid, rtol=1e-7)


H100_SHARED, H100_MOST = 107_376, 224_096  # what an H100 leaves a block: two an SM, and one


def _fixed(plan):
    generic = (plan.step, plan.window_size) != (10, 100)
    return plan.n_windows + (plan.window_size if generic else 0)


def _least(plan):
    """The shared memory of a row in 4-position tiles, the tail not staged."""
    m = -(-plan.window_size // plan.step)
    return (plan.step * (tf.GROUP + 4 * (-(-m // 4)) + 4) + tf.STAGE_PAD + _fixed(plan)) * 4


def _check_stage(plan, stage, budget):
    s = plan.step
    P = tf._conv_region_windows(plan)
    m = -(-plan.window_size // s)
    assert stage["smem_bytes"] == (stage["row_stage"] + _fixed(plan)) * 4 <= budget
    assert stage["tile_conv"] % 4 == 0 and stage["plane_stride"] % 4 == 0 and stage["row_stage"] % 4 == 0
    assert stage["n_tiles"] >= 1 and stage["n_tiles"] * stage["tile_conv"] >= P
    tail = packed_width(plan) - plan.packed_len
    planes = s * stage["plane_stride"]
    if stage["n_tiles"] == 1 and stage["plane_stride"] == plan.packed_len // s:
        # the packed row as it is: the planes run into each other, the look-ahead into the tail or the pad
        assert planes == plan.packed_len and stage["tail_off"] in (plan.packed_len, -1)
    elif P:
        assert stage["plane_stride"] - stage["tile_conv"] >= m - 1 + tf.GROUP
        assert (stage["n_tiles"] - 1) * stage["tile_conv"] < P  # no empty tile
    if stage["tail_off"] >= 0:
        assert stage["tail_off"] == planes and stage["tail_off"] % 4 == 0
        assert stage["row_stage"] >= planes + tail + tf.STAGE_PAD
    else:
        assert stage["row_stage"] >= planes + tf.STAGE_PAD
    tasks = tf.window_tasks(plan)
    ptr = tf.tile_task_ranges(tasks, stage["n_tiles"], stage["tile_conv"])
    assert ptr[0] == 0 and ptr[-1] == (tasks[:, 2] >= 0).sum() and (np.diff(ptr) >= 0).all()


@pytest.mark.parametrize("name", list(PLANS))
def test_stage_plan_on_the_card_budget_and_when_squeezed(name):
    _, plan = _plan(name)
    roomy = tf.stage_plan(plan, H100_SHARED, H100_MOST)
    _check_stage(plan, roomy, H100_SHARED)
    # these small plans fit one tile and their tail
    assert roomy["n_tiles"] == 1 and roomy["tail_off"] >= 0
    if not plan.n_reg_windows:
        return
    least = _least(plan)
    for cap in sorted({roomy["smem_bytes"] - 4, (roomy["smem_bytes"] + least) // 2, least + 64, least}):
        stage = tf.stage_plan(plan, cap, cap)
        _check_stage(plan, stage, cap)
        assert stage["n_tiles"] >= 2 or stage["tail_off"] == -1
    # a row that fits a whole SM but not half of one takes the whole SM rather than tiles
    assert tf.stage_plan(plan, roomy["smem_bytes"] - 4, roomy["smem_bytes"])["n_tiles"] == 1
    with pytest.raises(ValueError, match="no room"):
        tf.stage_plan(plan, least - 4, least - 4)


def test_stage_plan_at_the_benchmark_and_a_wide_genome():
    """20,000 genes: the whole row, two blocks an SM; 60,000 genes: column tiles, still two blocks an SM."""
    rng = np.random.default_rng(0)
    for n_genes, tiles in ((20_000, 1), (60_000, 3)):
        counts = np.maximum(1, rng.dirichlet(np.ones(22) * 5) * n_genes).astype(int)
        plan = build_window_plan(_var(list(counts)), 100, 10)
        stage = tf.stage_plan(plan, H100_SHARED, H100_MOST)
        _check_stage(plan, stage, H100_SHARED)
        assert stage["n_tiles"] == tiles


@pytest.mark.parametrize("name", list(PLANS))
@pytest.mark.parametrize("mode", ["roomy", "tiled", "smallest_tile"])
def test_staged_windows_match_the_plain_window_stage(name, mode):
    var, plan = _plan(name)
    if not plan.n_reg_windows:
        mode = "roomy"  # a plan of small chromosomes only has no conv region to tile
    rng = np.random.default_rng(3)
    lut = _pack_lut(plan, len(var))
    x = pack_columns(rng.normal(size=(5, len(var))).astype(np.float64), plan, lut)
    ref = pack_columns(rng.normal(size=(2, len(var))).astype(np.float64), plan, lut)
    xc = center(torch.from_numpy(x), torch.from_numpy(ref)).clamp_(-1.0, 1.0)
    want = smooth_packed(xc, plan).numpy()
    roomy = tf.stage_plan(plan, H100_SHARED, H100_MOST)
    least = _least(plan)
    cap = {"roomy": H100_MOST, "tiled": (roomy["smem_bytes"] + least) // 2, "smallest_tile": least}[mode]
    stage = tf.stage_plan(plan, min(cap, H100_SHARED), cap)
    if mode == "smallest_tile":
        assert stage["tile_conv"] == tf.GROUP
        assert stage["tail_off"] == -1 or packed_width(plan) == plan.packed_len  # no room for a tail
    got = tf.staged_windows_emulated(xc.numpy(), plan, stage)
    assert not np.isnan(got).any()
    npt.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


# ----- the gene kernel's index tables ---------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 19910, 19911, 19912, 19913])
def test_packed_gidx_copies_decode_to_the_table(n):
    rng = np.random.default_rng(n)
    gidx = np.cumsum(rng.integers(0, 2, size=n)).astype(np.int32)
    tab = packed_gidx(gidx)
    assert tab.shape[0] == 4 and tab.shape[1] >= max(n // 4, 1) and tab.dtype == np.int32
    for h in range(4):
        n4 = max(n - h, 0) // 4
        npt.assert_array_equal(unpack_gidx(tab, h, n), gidx[h : h + 4 * n4])
        assert not tab[h, n4:].any()


def test_packed_gidx_of_every_plan_and_tables_that_do_not_pack():
    for name in PLANS:
        gpd = gene_projection_data(_plan(name)[1])
        steps = np.diff(gpd.gidx_sorted)
        assert steps.size == 0 or (steps.min() >= 0 and steps.max() <= 1), name
        assert packed_gidx(gpd.gidx_sorted) is not None, name
    assert packed_gidx(np.array([0, 15, 30, 45, 60])) is not None
    assert packed_gidx(np.array([0, 16, 17, 18])) is None  # a step of 16
    assert packed_gidx(np.array([3, 2, 4, 5])) is None  # not monotone
    assert packed_gidx(np.array([0, 1, 2, 1 << 19])) is None


@pytest.mark.parametrize("rows,name", [(3, "w100s10_mixed"), (4, "w40s7"), (5, "w9s3")])
def test_vector_store_walk_writes_every_column_once(rows, name):
    """The kernel's expansion, walked in Python: head peel, 16-byte groups from copy ``head``, tail."""
    _, plan = _plan(name)
    gpd = gene_projection_data(plan)
    n = gpd.total
    tab = packed_gidx(gpd.gidx_sorted)
    u = np.random.default_rng(0).normal(size=(rows, gpd.n_groups)).astype(np.float32)
    out = np.full(rows * n, np.nan, np.float32)
    for row in range(rows):
        base = row * n  # float offset of the row in an allocation aligned to 16 bytes
        head = min((-base) % 4, n)
        n4 = (n - head) // 4
        out[base : base + head] = u[row, gpd.gidx_sorted[:head]]
        assert (base + head) % 4 == 0 or n4 == 0
        out[base + head : base + head + 4 * n4] = u[row, unpack_gidx(tab, head, n)]
        tail = np.arange(head + 4 * n4, n)
        out[base + tail] = u[row, gpd.gidx_sorted[tail]]
    npt.assert_array_equal(out.reshape(rows, n), u[:, gpd.gidx_sorted])
