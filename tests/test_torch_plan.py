"""Host layer of the PyTorch port against the JAX package: plans, LUTs, packed blocks, COO remap.

Every array must be EQUAL (not close): the port copies these host functions.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from infercnvpy_tpu.datasets import synthetic_cnv_dataset  # noqa: E402
from infercnvpy_tpu.genome import build_window_plan as jax_build_plan  # noqa: E402
from infercnvpy_tpu.ops import infercnv_kernel as jik  # noqa: E402
from infercnvpy_tpu.ops import sparse_ingest as jsi  # noqa: E402
from infercnvpy_tpu_torch.genome import WindowPlan, build_window_plan  # noqa: E402
from infercnvpy_tpu_torch.ops import infercnv_kernel as tik  # noqa: E402
from infercnvpy_tpu_torch.ops import sparse_ingest as tsi  # noqa: E402

# (chrom spec, window, step): the genomes of tests/test_reference_differential.py CONFIGS
GENOMES = [
    ([("chr1", 220), ("chr2", 150), ("chr3", 40)], 100, 10),
    ([("chr1", 130), ("chr7", 7), ("chr11", 90)], 11, 3),
    ([("chr2", 64), ("chrM", 10), ("weird", 5), ("chr10", 101)], 25, 5),
    ([("chr1", 99), ("chr2", 100)], 100, 10),
    ([("chr1", 300)], 50, 1),
    ([("chr1", 120), ("chr2", 60)], 30, 30),
    ([("chr1", 50), ("chr2", 50)], 50, 10),
    ("synthetic", 100, 10),
]
IDS = ["3chrom", "w11s3", "chrM_weird", "all_small", "step1", "window_eq_step", "g_eq_window", "synthetic"]

PLAN_FIELDS = [
    "packed_src", "conv_gather", "small_src", "small_seg", "small_counts", "final_src", "used_genes",
    "gene_win_lo", "gene_win_hi",
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _make_var(rng, spec):
    if spec == "synthetic":
        var = synthetic_cnv_dataset(n_cells=4, n_genes=4000, seed=0).var
        return var[~var["chromosome"].isin(["chrX", "chrY"])]
    rows = []
    for chrom, g in spec:
        for s in np.sort(rng.integers(1, 10**7, size=g)):
            rows.append((chrom, int(s), int(s) + 100))
    var = pd.DataFrame(rows, columns=["chromosome", "start", "end"])
    var.index = pd.Index([f"gene{i}" for i in range(len(var))])
    return var


def _plans(spec, window, step, seed=0):
    var = _make_var(np.random.default_rng(seed), spec)
    return var, jax_build_plan(var, window, step), build_window_plan(var, window, step)


def _assert_plans_equal(a, b):
    assert (a.window_size, a.step, a.n_windows, a.packed_len) == (b.window_size, b.step, b.n_windows, b.packed_len)
    assert a.chromosomes == b.chromosomes
    assert a.chr_pos == b.chr_pos
    assert a.cache_key == b.cache_key
    for f in PLAN_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        npt.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("spec,window,step", GENOMES, ids=IDS)
def test_plan_equal(spec, window, step):
    _, jplan, tplan = _plans(spec, window, step)
    _assert_plans_equal(jplan, tplan)
    assert tplan.n_small == jplan.n_small
    npt.assert_array_equal(tplan.pyramid, jplan.pyramid)
    assert tplan.pyramid_sum == jplan.pyramid_sum


@pytest.mark.parametrize("spec,window,step", GENOMES, ids=IDS)
def test_from_arrays_round_trips_jax_plan(spec, window, step):
    _, jplan, _ = _plans(spec, window, step)
    plan = WindowPlan.from_arrays(
        window_size=jplan.window_size, step=jplan.step, chromosomes=jplan.chromosomes, chr_pos=jplan.chr_pos,
        n_windows=jplan.n_windows, packed_len=jplan.packed_len,
        **{f: getattr(jplan, f) for f in PLAN_FIELDS},
    )
    _assert_plans_equal(jplan, plan)
    # copies, not views of the source plan
    assert not np.shares_memory(plan.packed_src, jplan.packed_src)


@pytest.mark.parametrize("spec,window,step", GENOMES, ids=IDS)
def test_lut_and_packed_blocks_equal(spec, window, step):
    var, jplan, tplan = _plans(spec, window, step)
    n_genes = len(var)
    jlut = jik._pack_lut(jplan, n_genes)
    tlut = tik._pack_lut(tplan, n_genes)
    npt.assert_array_equal(jlut, tlut)
    assert tik.packed_width(tplan) == jik.packed_width(jplan)

    rng = np.random.default_rng(1)
    x = rng.normal(size=(13, n_genes)).astype(np.float32)
    x[rng.random(x.shape) < 0.6] = 0
    for dt in (np.float32, np.float64):
        a = jik.pack_columns(x, jplan, jlut, dtype=dt)
        b = tik.pack_columns(x, tplan, tlut, dtype=dt)
        assert a.dtype == b.dtype
        npt.assert_array_equal(a, b)
        a = jik.pack_csr(sp.csr_matrix(x), jplan, jlut, dtype=dt)
        b = tik.pack_csr(sp.csr_matrix(x), tplan, tlut, dtype=dt)
        assert a.dtype == b.dtype
        npt.assert_array_equal(a, b)


@pytest.mark.parametrize("spec,window,step", GENOMES, ids=IDS)
def test_coo_from_csr_batch_equal(spec, window, step):
    var, jplan, tplan = _plans(spec, window, step)
    n_genes = len(var)
    lut = tik._pack_lut(tplan, n_genes)
    width = tik.packed_width(tplan)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(11, n_genes)).astype(np.float32)
    x[rng.random(x.shape) < 0.7] = 0
    x[3] = 0  # an empty row
    csr = sp.csr_matrix(x)
    for cap in (None, csr.nnz + 37):
        for vdt in (np.float32, np.float64):
            a = jsi.coo_from_csr_batch(csr, lut, width, cap, val_dtype=vdt)
            b = tsi.coo_from_csr_batch(csr, lut, width, cap, val_dtype=vdt)
            assert a[3] == b[3]
            for u, v in zip(a[:3], b[:3]):
                assert u.dtype == v.dtype
                npt.assert_array_equal(u, v)
    assert tsi.col_index_dtype(width) == jsi.col_index_dtype(width)


@pytest.mark.parametrize("nnz", [0, 1, 1 << 20, (1 << 20) + 1, 5_000_000])
def test_round_nnz_cap_equal(nnz):
    assert tsi.round_nnz_cap(nnz) == jsi.round_nnz_cap(nnz)


# hg38 autosome lengths (Mb): the benchmark genome of chip_smoke.py
_CHR_MB = np.array([248, 242, 198, 190, 181, 171, 159, 145, 138, 134, 135, 133,
                    114, 107, 102, 90, 83, 80, 59, 64, 47, 51], dtype=float)


def _bench_var(n_genes, seed=0):
    """22 autosomes, genes proportional to chromosome length (``chip_smoke.make_var``)."""
    rng = np.random.default_rng(seed)
    counts = np.maximum(1, (_CHR_MB / _CHR_MB.sum() * n_genes)).astype(int)
    counts[0] += n_genes - counts.sum()
    rows = []
    for c, k in enumerate(counts):
        rows.extend((f"chr{c + 1}", int(s)) for s in np.sort(rng.integers(1, int(_CHR_MB[c] * 1e6), size=k)))
    var = pd.DataFrame(rows, columns=["chromosome", "start"])
    var["end"] = var["start"] + 1000
    var.index = pd.Index([f"gene_{i}" for i in range(len(var))])
    return var


def test_packed_layout_holds_genes_past_the_last_window():
    """At 3,000 genes a chromosome's genes past its last window overrun the JAX package's layout."""
    import infercnvpy_tpu as cnv
    import infercnvpy_tpu_torch as tcnv

    var = _bench_var(3000)
    with pytest.raises(ValueError, match="could not broadcast"):
        jax_build_plan(var, 100, 10)
    plan = build_window_plan(var, 100, 10)
    assert plan.packed_len % (128 * 10) == 0
    # every gene of a regular chromosome has its packed column
    n_regular = sum(len(g) for g in var.groupby("chromosome").groups.values() if len(g) > 100)
    assert (plan.packed_src >= 0).sum() == n_regular

    rng = np.random.default_rng(5)
    n_cells = 60
    X = rng.normal(size=(n_cells, len(var)))  # float64: the f64 bar
    obs = pd.DataFrame({"grp": ["ref" if i % 4 == 0 else "q" for i in range(n_cells)]},
                       index=[f"c{i}" for i in range(n_cells)])
    kw = dict(reference_key="grp", reference_cat="ref", chunksize=16, inplace=False)
    pos, got, _ = tcnv.tl.infercnv(tcnv.AnnData(X=X, obs=obs, var=var), device="cpu", **kw)
    # the tail genes lie in no window: without them the JAX package builds its plan and agrees.
    # A chromosome keeps window_size + 1 genes, so that it stays regular (more genes than the window)
    tail = []
    for idx in var.groupby("chromosome").indices.values():
        idx = idx[np.argsort(var["start"].values[idx], kind="stable")]
        if len(idx) > 100:
            n_win = (len(idx) - 100) // 10 + 1
            tail.extend(idx[max(10 * (n_win - 1) + 100, 101) :])
    assert len(tail) > 0 and (plan.gene_win_lo[np.isin(plan.used_genes, tail)] < 0).all()
    keep = np.setdiff1d(np.arange(len(var)), tail)
    jpos, want, _ = cnv.tl.infercnv(cnv.AnnData(X=X[:, keep], obs=obs, var=var.iloc[keep]), mesh=False, **kw)
    assert pos == jpos
    npt.assert_allclose(got.toarray(), want.toarray(), rtol=1e-9, atol=1e-12)
