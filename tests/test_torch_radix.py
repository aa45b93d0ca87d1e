"""The new kernels' algorithms, in their Python transcriptions, on the CPU.

The CUDA sources cannot run here, so their arithmetic is kept in Python beside
them: ``ops.select.radix_select_emulated`` repeats the radix select of
``csrc/select.cuh`` (digits, histograms, bin scan, the two ranks of an even
total, weights), ``ops.fused.window_tasks`` / ``stage_plan`` /
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
