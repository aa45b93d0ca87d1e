"""The port's gene projection and weighted / k-th selects against the JAX package.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
kernels (``pallas_gene.gene_project``, ``pallas_select.row_median_weighted``
and ``row_kth_smallest``) run in Pallas interpret mode, as
``tests/test_pallas.py`` runs them.  Cases marked ``cuda`` hold the CUDA
kernels against the plain versions and skip where no GPU is present.  They
need neither JAX nor the JAX package, so on a GPU machine they run with

    python -m pytest tests/test_torch_gene.py -m cuda --noconftest -p no:cacheprovider

Bars: gene values at rtol 1e-5 / atol 1e-5 against JAX (``tests/test_pallas.py:199``;
JAX forms each group mean as a prefix-sum difference, the port as a direct
sum); kernel vs plain at rtol 1e-5 / atol 1e-6 ungated, gate patterns by
agreement share (a value within round-off of the threshold may flip); the
selects exactly.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from infercnvpy_tpu_torch.genome import WindowPlan, build_window_plan  # noqa: E402
from infercnvpy_tpu_torch.ops import gene as tg  # noqa: E402
from infercnvpy_tpu_torch.ops.select import (  # noqa: E402
    row_kth_smallest,
    row_kth_smallest_cuda,
    row_kth_smallest_plain,
    row_median_weighted,
    row_median_weighted_cuda,
    row_median_weighted_plain,
)

# the genome of tests/test_pallas.py:114-117 (small chromosomes, uncovered
# genes at the ends of the regular ones), plus one without and one with only
# small chromosomes
SPEC_MIXED = [150, 40, 7, 90]
PLAN_CASES = [
    (SPEC_MIXED, 100, 10),
    (SPEC_MIXED, 9, 3),
    (SPEC_MIXED, 11, 7),
    (SPEC_MIXED, 11, 1),
    ([150, 230, 20], 21, 3),
    ([40, 7], 100, 10),
]
PLAN_IDS = ["w100s10", "w9s3", "w11s7", "w11s1", "w21s3", "only_small"]
GPD_FIELDS = ["g_lo", "g_hi", "g_counts", "gidx_sorted", "covered_sorted"]


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
    return torch.device("cuda")


def _var(counts):
    rows = [(f"chr{c + 1}", i * 100) for c, g in enumerate(counts) for i in range(g)]
    var = pd.DataFrame(rows, columns=["chromosome", "start"])
    var["end"] = var["start"] + 1
    return var


def _jax_plan(var, window, step):
    from infercnvpy_tpu.genome import build_window_plan as jax_build_plan

    return jax_build_plan(var, window, step)


def _from_jax_plan(jplan) -> WindowPlan:
    fields = [
        "window_size", "step", "chromosomes", "chr_pos", "n_windows", "packed_len", "packed_src", "conv_gather",
        "small_src", "small_seg", "small_counts", "final_src", "used_genes", "gene_win_lo", "gene_win_hi",
    ]
    return WindowPlan.from_arrays(**{f: getattr(jplan, f) for f in fields})


def _assert_gpd_equal(got, want):
    assert got.n_windows == want.n_windows
    assert got.total == want.total == len(got.covered_sorted)
    for f in GPD_FIELDS:
        npt.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f


@pytest.mark.parametrize("counts,window,step", PLAN_CASES, ids=PLAN_IDS)
@pytest.mark.parametrize("source", ["built", "from_arrays"])
def test_projection_data_matches_jax(counts, window, step, source):
    from infercnvpy_tpu.ops.pallas_gene import gene_projection_data as jax_gpd

    var = _var(counts)
    jplan = _jax_plan(var, window, step)
    tplan = build_window_plan(var, window, step) if source == "built" else _from_jax_plan(jplan)
    got = tg.gene_projection_data(tplan)
    _assert_gpd_equal(got, jax_gpd(jplan))
    assert got.n_groups == len(got.g_counts) and int(got.g_counts.sum()) == got.total
    # the last (g - window) % step genes of a regular chromosome are covered by no window
    uncovered = sum((g - window) % step for g in counts if g > window)
    assert got.total == len(tplan.used_genes) - uncovered


def test_projection_cache_is_keyed_by_plan_content():
    var = _var([30, 20])
    a = build_window_plan(var, 10, 2)
    b = build_window_plan(var, 10, 2)
    assert a is not b and a.cache_key == b.cache_key
    gpd = tg.gene_projection_data(a)
    assert tg.gene_projection_data(b) is gpd
    assert tg._gpd_cache[a.cache_key] is gpd
    assert not any(v is a for v in tg._gpd_cache.values())  # no plan is pinned
    other = build_window_plan(var, 10, 3)
    assert other.cache_key != a.cache_key
    assert tg.gene_projection_data(other) is not gpd
    assert other.cache_key in tg._gpd_cache


def _gene_inputs(n_windows, n_cells=21, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_cells, n_windows)).astype(dtype)
    thr = (np.abs(rng.normal(size=n_cells)) * 0.4).astype(dtype)
    return x, thr


@pytest.mark.parametrize("gate", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("counts,window,step", PLAN_CASES, ids=PLAN_IDS)
def test_gene_project_plain_matches_jax(counts, window, step, gate):
    from infercnvpy_tpu.ops.pallas_gene import gene_project as jax_gene_project
    from infercnvpy_tpu.ops.pallas_gene import gene_projection_data as jax_gpd

    var = _var(counts)
    jplan = _jax_plan(var, window, step)
    tplan = build_window_plan(var, window, step)
    x, thr = _gene_inputs(tplan.n_windows, n_cells=24)
    thr8 = np.zeros((x.shape[0], 8), np.float32)
    thr8[:, 0] = thr
    want = np.asarray(jax_gene_project(x, thr8, jax_gpd(jplan), gate=gate, row_tile=8))
    got = tg.gene_project(torch.from_numpy(x), torch.from_numpy(thr), tg.gene_projection_data(tplan), gate=gate)
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == want.shape == (x.shape[0], tg.gene_projection_data(tplan).total)
    npt.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[want == 0] == 0).all()
    if gate:
        npt.assert_array_equal(got == 0, want == 0)


def test_gene_project_f64_matches_f32_and_gates_like_the_windows():
    tplan = build_window_plan(_var(SPEC_MIXED), 100, 10)
    gpd = tg.gene_projection_data(tplan)
    x, thr = _gene_inputs(tplan.n_windows, dtype=np.float64)
    got64 = tg.gene_project(torch.from_numpy(x), torch.from_numpy(thr), gpd, gate=True)
    assert got64.dtype == torch.float64
    got32 = tg.gene_project(torch.from_numpy(x.astype(np.float32)), torch.from_numpy(thr.astype(np.float32)), gpd,
                            gate=True)
    npt.assert_allclose(got32.numpy(), got64.numpy(), rtol=1e-5, atol=1e-5)
    # gated entries are exactly the ones under the row threshold
    ungated = tg.gene_project(torch.from_numpy(x), None, gpd, gate=False).numpy()
    npt.assert_array_equal(got64.numpy(), np.where(np.abs(ungated) < thr[:, None], 0.0, ungated))


def test_gene_project_rejects_bad_inputs():
    tplan = build_window_plan(_var(SPEC_MIXED), 100, 10)
    gpd = tg.gene_projection_data(tplan)
    x, thr = _gene_inputs(tplan.n_windows)
    xt, tt = torch.from_numpy(x), torch.from_numpy(thr)
    with pytest.raises(ValueError, match="x_res must be"):
        tg.gene_project(xt[:, 1:], tt, gpd, gate=True)
    with pytest.raises(ValueError, match="row_thr"):
        tg.gene_project(xt, None, gpd, gate=True)
    with pytest.raises(ValueError, match="float32 or float64"):
        tg.gene_project(xt.half(), tt, gpd, gate=True)
    with pytest.raises(ValueError, match="CUDA"):
        tg.gene_project_cuda(xt, tt, gpd, gate=True)


# ---------------------------------------------------------------------------
# weighted median (K4) and k-th smallest (K5)
# ---------------------------------------------------------------------------


def _wmedian_case(w, seed, n=8, dtype=np.float32):
    """The cases of tests/test_pallas.py:46-61: weights in [0, 7), so some columns are masked."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, w)).astype(dtype)
    wts = rng.integers(0, 7, size=w).astype(np.int32)
    wts[0] = 3  # ensure nonzero total
    return x, wts


def _np_wmedian(x, wts):
    return np.stack([np.median(np.repeat(row, wts)) for row in x]).astype(x.dtype)


def _assert_median_equal(got, want):
    # value-equal; only the sign of a zero median may differ from numpy's
    npt.assert_array_equal(got, want)
    nz = want != 0
    npt.assert_array_equal(got[nz].view(np.uint8), want[nz].view(np.uint8))


WMEDIAN_CASES = [(9, 0), (128, 1), (1793, 2), (2, 3), (1, 4)]


@pytest.mark.parametrize("w,seed", WMEDIAN_CASES)
def test_row_median_weighted_plain_matches_numpy_and_jax(w, seed):
    from infercnvpy_tpu.ops.pallas_select import row_median_weighted as jax_wmedian

    x, wts = _wmedian_case(w, seed)
    got = row_median_weighted(torch.from_numpy(x), wts).numpy()
    assert got.dtype == np.float32
    _assert_median_equal(got, _np_wmedian(x, wts))
    want = np.asarray(jax_wmedian(x, wts, row_tile=8))
    npt.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("total", ["odd", "even"])
def test_row_median_weighted_duplicated_middle_key(total):
    """An even total whose rank-k_hi key is duplicated: the lower middle is that key again."""
    from infercnvpy_tpu.ops.pallas_select import row_median_weighted as jax_wmedian

    x = np.array([[1.0, 2.0, 2.0, 3.0, -0.0, 0.0], [5.0, 5.0, 5.0, -1.0, 7.0, 7.0]], np.float32)
    wts = np.array([1, 2, 1, 1, 0, 1] if total == "even" else [1, 2, 1, 1, 0, 2], np.int32)
    assert int(wts.sum()) % 2 == (total == "odd")
    got = row_median_weighted_plain(torch.from_numpy(x), torch.from_numpy(wts)).numpy()
    _assert_median_equal(got, _np_wmedian(x, wts))
    npt.assert_array_equal(got.view(np.uint32), np.asarray(jax_wmedian(x, wts, row_tile=2)).view(np.uint32))


def test_row_median_weighted_uniform_is_the_median_and_f64():
    from infercnvpy_tpu_torch.ops.select import row_median_plain

    x = np.random.default_rng(5).normal(size=(8, 101))
    for dt in (np.float32, np.float64):
        xt = torch.from_numpy(x.astype(dt))
        got = row_median_weighted_plain(xt, np.ones(101, np.int32))
        assert got.dtype == xt.dtype
        npt.assert_array_equal(got.numpy(), row_median_plain(xt).numpy())
    x, wts = _wmedian_case(128, 6, dtype=np.float64)
    _assert_median_equal(row_median_weighted_plain(torch.from_numpy(x), wts).numpy(), _np_wmedian(x, wts))


def test_row_median_weighted_edge_cases():
    x = torch.ones((3, 4))
    npt.assert_array_equal(row_median_weighted_plain(x, np.zeros(4, np.int32)).numpy(), np.zeros(3))
    assert row_median_weighted_plain(torch.ones((0, 4)), np.ones(4, np.int32)).shape == (0,)
    with pytest.raises(ValueError, match="shape"):
        row_median_weighted_plain(x, np.ones(5, np.int32))
    with pytest.raises(ValueError, match=">= 0"):
        row_median_weighted_plain(x, np.array([1, -1, 1, 1]))
    with pytest.raises(ValueError, match="CUDA"):
        row_median_weighted_cuda(x, np.ones(4, np.int32))


@pytest.mark.parametrize("kind", ["list", "numpy_int32", "numpy_int64", "torch_int32"])
def test_weights_are_checked_on_the_host(kind):
    """One check for every kind of weight vector: the same int64 tensor, total and errors."""
    from infercnvpy_tpu_torch.ops.select import _weights

    def make(v):
        return {"list": list(v), "numpy_int32": np.asarray(v, np.int32), "numpy_int64": np.asarray(v, np.int64),
                "torch_int32": torch.tensor(v, dtype=torch.int32)}[kind]

    wts, total = _weights(make([3, 0, 2, 1]), 4, torch.device("cpu"))
    assert wts.dtype == torch.int64 and wts.device.type == "cpu" and total == 6
    npt.assert_array_equal(wts.numpy(), [3, 0, 2, 1])
    with pytest.raises(ValueError, match=r"weights must have shape \(4,\), got \(5,\)"):
        _weights(make([1, 1, 1, 1, 1]), 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="weights must be >= 0"):
        _weights(make([1, -1, 1, 1]), 4, torch.device("cpu"))


@pytest.mark.cuda
def test_device_weights_are_checked_on_the_device(cuda):
    """Weights on the card: the same int64 tensor, total and errors as from the host, without leaving the card."""
    from infercnvpy_tpu_torch.ops.select import _weights

    wts, total = _weights(torch.tensor([3, 0, 2, 1], dtype=torch.int32, device=cuda), 4, cuda)
    assert wts.dtype == torch.int64 and wts.is_cuda and total == 6
    npt.assert_array_equal(wts.cpu().numpy(), [3, 0, 2, 1])
    with pytest.raises(ValueError, match=r"weights must have shape \(4,\), got \(5,\)"):
        _weights(torch.ones(5, dtype=torch.int32, device=cuda), 4, cuda)
    with pytest.raises(ValueError, match="weights must be >= 0"):
        _weights(torch.tensor([1, -1, 1, 1], device=cuda), 4, cuda)


@pytest.mark.parametrize("k", [0, 16, 32])
def test_row_kth_smallest_plain_matches_numpy_and_jax(k):
    from infercnvpy_tpu.ops.pallas_select import row_kth_smallest as jax_kth

    x = np.random.default_rng(1).normal(size=(8, 33)).astype(np.float32)
    got = row_kth_smallest(torch.from_numpy(x), k).numpy()
    npt.assert_array_equal(got, np.sort(x, axis=1)[:, k])
    npt.assert_array_equal(got.view(np.uint32), np.asarray(jax_kth(x, k, row_tile=8)).view(np.uint32))


def test_row_kth_smallest_edge_cases():
    x = np.random.default_rng(2).normal(size=(5, 7))
    npt.assert_array_equal(row_kth_smallest_plain(torch.from_numpy(x), 3).numpy(), np.sort(x, axis=1)[:, 3])
    for k in (-1, 7):
        with pytest.raises(ValueError, match="outside"):
            row_kth_smallest_plain(torch.from_numpy(x), k)
    with pytest.raises(ValueError, match="CUDA"):
        row_kth_smallest_cuda(torch.from_numpy(x.astype(np.float32)), 0)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (GPU only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("counts,window,step", PLAN_CASES, ids=PLAN_IDS)
def test_gene_kernel_matches_plain_on_gpu(cuda, counts, window, step, gate):
    tplan = build_window_plan(_var(counts), window, step)
    gpd = tg.gene_projection_data(tplan)
    x, thr = _gene_inputs(tplan.n_windows, n_cells=300)
    xd, td = torch.from_numpy(x).to(cuda), torch.from_numpy(thr).to(cuda)
    before = tg.gene_project_cuda.launches
    got = tg.gene_project(xd, td, gpd, gate=gate)
    assert tg.gene_project_cuda.launches == before + 1
    want = tg.gene_project_plain(xd, td, gpd, gate=gate)
    torch.cuda.synchronize()
    if gate:
        assert int(((got == 0) != (want == 0)).sum()) <= 1e-4 * got.numel()
        both = (got != 0) & (want != 0)
        torch.testing.assert_close(got[both], want[both], rtol=1e-5, atol=1e-6)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _gpu_weight_cases(w, seed):
    """Weights in [0, 7) (tests/test_pallas.py), the bench plan's equal 10s, uneven 0-64 with ~10 % zeros, one live
    column, and one weight past 16 bits (a total past 16 bits: the 32-bit weight table); each with an even and an
    odd total."""
    rng = np.random.default_rng(seed)
    _, pallas = _wmedian_case(w, seed)
    uneven = rng.integers(1, 65, size=w)
    uneven[rng.random(w) < 0.1] = 0
    uneven[0] += 1
    single = np.zeros(w, np.int64)
    single[w // 2] = 7
    big = rng.integers(0, 3, size=w)
    big[w // 3] = 70_000
    cases = {"pallas": pallas, "equal": np.full(w, 10), "uneven": uneven, "one_live": single, "past_16_bits": big}
    out = {}
    for name, wts in cases.items():
        for parity in (0, 1):
            w2 = np.asarray(wts, np.int64).copy()
            w2[np.flatnonzero(w2)[0]] += (int(w2.sum()) + parity) % 2
            out[f"{name}_{'odd' if parity else 'even'}"] = w2
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("w,seed", WMEDIAN_CASES + [(1991, 5), (2048, 6), (2049, 7), (20_000, 8)])
def test_weighted_median_kernel_bit_identical_on_gpu(cuda, w, seed):
    """Warp kernel up to 2,048 columns, block kernel above: continuous, tied, all-equal and two-valued rows."""
    x, _ = _wmedian_case(w, seed, n=64)
    x[1] = np.round(x[1] * 8) / 8
    x[2] = 0.25
    x[3, : w // 2] = -1.5
    x[4] = np.where(x[4] > 0, np.float32(1.5), np.float32(-0.0))
    xd = torch.from_numpy(x).to(cuda)
    before = dict(row_median_weighted_cuda.launches_by_variant)
    cases = _gpu_weight_cases(w, seed)
    for name, wts in cases.items():
        want = row_median_weighted_plain(xd, wts)
        for where in ("host", "card"):
            got = row_median_weighted(xd, wts if where == "host" else torch.from_numpy(wts).to(cuda))
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (name, where)
    ran = {v: row_median_weighted_cuda.launches_by_variant[v] - n for v, n in before.items()}
    variant = "warp" if w <= 2048 else "block"
    assert ran == {variant: 2 * len(cases), ({"warp", "block"} - {variant}).pop(): 0}


@pytest.mark.cuda
@pytest.mark.parametrize("width", [33, 2048, 2049, 20000])  # the warp kernel up to 2,048 values, the block one above
@pytest.mark.parametrize("at", ["first", "middle", "last"])
def test_kth_smallest_kernel_bit_identical_on_gpu(cuda, width, at):
    k = {"first": 0, "middle": width // 2, "last": width - 1}[at]
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(64, width)).astype(np.float32)).to(cuda)
    got = row_kth_smallest(x, k)
    want = row_kth_smallest_plain(x, k)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _plan_with_total_mod4(residue):
    """A mixed plan whose number of covered genes is ``residue`` modulo 4."""
    for extra in range(16):
        tplan = build_window_plan(_var([150, 40, 7 + extra, 90]), 100, 10)
        if tg.gene_projection_data(tplan).total % 4 == residue:
            return tplan
    raise AssertionError(f"no plan with n_covered = {residue} mod 4")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2, 7, 300])
@pytest.mark.parametrize("residue", [0, 1, 2, 3])
def test_gene_kernel_row_alignment_on_gpu(cuda, residue, rows):
    """Rows start 0, 4, 8 or 12 bytes off a 16-byte address: ungated stays bit-identical."""
    tplan = _plan_with_total_mod4(residue)
    gpd = tg.gene_projection_data(tplan)
    x, thr = _gene_inputs(tplan.n_windows, n_cells=rows, seed=residue)
    xd, td = torch.from_numpy(x).to(cuda), torch.from_numpy(thr).to(cuda)
    got = tg.gene_project_cuda(xd, td, gpd, gate=False)
    want = tg.gene_project_plain(xd, td, gpd, gate=False)
    torch.cuda.synchronize()
    assert got.shape == (rows, gpd.total) and gpd.total % 4 == residue
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_gene_tables_are_cached_per_plan_and_cleared(cuda):
    from infercnvpy_tpu_torch.tl import clear_transform_caches

    clear_transform_caches()
    tplan = build_window_plan(_var(SPEC_MIXED), 100, 10)
    x, thr = _gene_inputs(tplan.n_windows, n_cells=4)
    xd, td = torch.from_numpy(x).to(cuda), torch.from_numpy(thr).to(cuda)
    tg.gene_project_cuda(xd, td, tg.gene_projection_data(tplan), gate=True)
    assert len(tg._device_tables) == 1
    first = next(iter(tg._device_tables.values()))[4].data_ptr()
    again = build_window_plan(_var(SPEC_MIXED), 100, 10)
    tg.gene_project_cuda(xd, td, tg.gene_projection_data(again), gate=True)
    assert len(tg._device_tables) == 1 and next(iter(tg._device_tables.values()))[4].data_ptr() == first
    clear_transform_caches()
    assert not tg._device_tables and not tg._gpd_cache


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [False, True], ids=["ungated", "gated"])
def test_gene_kernel_takes_a_table_that_does_not_pack(cuda, gate):
    """Groups numbered against column order have no packed copies: the kernel expands column by column."""
    from dataclasses import replace

    tplan = build_window_plan(_var(SPEC_MIXED), 100, 10)
    gpd = tg.gene_projection_data(tplan)
    flipped = replace(
        gpd, g_lo=gpd.g_lo[::-1].copy(), g_hi=gpd.g_hi[::-1].copy(), g_counts=gpd.g_counts[::-1].copy(),
        gidx_sorted=(gpd.n_groups - 1 - gpd.gidx_sorted).astype(np.int32), cache_key="",
    )
    assert tg.packed_gidx(flipped.gidx_sorted) is None
    x, thr = _gene_inputs(tplan.n_windows, n_cells=301)
    xd, td = torch.from_numpy(x).to(cuda), torch.from_numpy(thr).to(cuda)
    got = tg.gene_project_cuda(xd, td, flipped, gate=gate)
    want = tg.gene_project_cuda(xd, td, gpd, gate=gate)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
