"""``infercnvpy_tpu_torch.tl.infercnv`` against ``infercnvpy_tpu.tl.infercnv`` on the same inputs.

f64 runs must agree at the reference-differential bar (rtol 1e-9, atol
1e-12).  In f32 the JAX package's CPU path smooths by cumsum differences
(``infercnvpy_tpu/ops/infercnv_kernel.py:193``) while the port sums each
window directly, so values agree at rtol 1e-5, atol 1e-5, and an entry may be
gated in one and not the other only where its value lies within 1e-5 of the
chunk's threshold.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import infercnvpy_tpu as cnv  # noqa: E402
import infercnvpy_tpu_torch as tcnv  # noqa: E402

CATS = ["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"]
FLIP_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def oligo():
    return tcnv.datasets.oligodendroglioma()


def _both(adata_t, **kw):
    """Run both packages on copies of one port AnnData; returns (port, jax) results."""
    a_t = adata_t.copy()
    a_j = cnv.AnnData(X=adata_t.X.copy(), obs=adata_t.obs.copy(), var=adata_t.var.copy())
    got = tcnv.tl.infercnv(a_t, inplace=False, device="cpu", **kw)
    want = cnv.tl.infercnv(a_j, inplace=False, mesh=False, **kw)
    return got, want


def _chunk_thresholds(adata_t, chunksize, dynamic_threshold=1.5, **kw):
    """Per-row gate threshold from the port's ungated result."""
    _, pre, _ = tcnv.tl.infercnv(
        adata_t.copy(), inplace=False, device="cpu", dynamic_threshold=None, chunksize=chunksize, **kw
    )
    pre = pre.toarray().astype(np.float64)
    thr = np.empty(pre.shape[0])
    for s in range(0, pre.shape[0], chunksize):
        thr[s : s + chunksize] = dynamic_threshold * pre[s : s + chunksize].std()
    return thr


def _assert_f32_close(got, want, row_thr):
    g = got.toarray()
    w = want.toarray()
    flip = (g == 0) != (w == 0)
    v = np.abs(np.where(g != 0, g, w))
    near = np.abs(v - row_thr[:, None]) <= FLIP_TOL
    assert near[flip].all(), f"{int((flip & ~near).sum())} gate flips away from the threshold"
    npt.assert_allclose(g[~flip], w[~flip], rtol=1e-5, atol=1e-5)


def _assert_same_csr(a, b):
    assert a.shape == b.shape
    npt.assert_array_equal(a.indptr, b.indptr)
    npt.assert_array_equal(a.indices, b.indices)
    assert a.data.dtype == b.data.dtype
    npt.assert_array_equal(a.data.view(np.uint8), b.data.view(np.uint8))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rep", [np.asarray, sp.csr_matrix, sp.csc_matrix], ids=["dense", "csr", "csc"])
def test_oligodendroglioma_matches_jax(oligo, rep, dtype):
    adata = oligo.copy()
    adata.X = rep(adata.X.toarray().astype(dtype))
    kw = dict(reference_key="cell_type", reference_cat=CATS)
    (pos_t, got, genes), (pos_j, want, _) = _both(adata, **kw)
    assert genes is None
    assert pos_t == pos_j
    assert got.shape == want.shape == (adata.n_obs, 180)
    assert got.dtype == want.dtype == dtype
    if dtype == np.float64:
        npt.assert_allclose(got.toarray(), want.toarray(), rtol=1e-9, atol=1e-12)
    else:
        _assert_f32_close(got, want, _chunk_thresholds(adata, 5000, **kw))


def _bench_adata(n_cells=512, n_genes=2000, density=0.05, seed=1):
    """A small AnnData made the way bench.py makes its e2e CSR (bench.py:32-45, 172-180)."""
    rng = np.random.default_rng(0)
    sizes = np.array([248, 242, 198, 190, 181, 171, 159, 145, 138, 134, 135, 133,
                      114, 107, 102, 90, 83, 80, 59, 64, 47, 51], dtype=float)
    counts = np.maximum(1, (sizes / sizes.sum() * n_genes)).astype(int)
    counts[0] += n_genes - counts.sum()
    rows = [(f"chr{c + 1}", int(s)) for c, k in enumerate(counts)
            for s in np.sort(rng.integers(1, int(sizes[c] * 1e6), size=k))]
    var = pd.DataFrame(rows, columns=["chromosome", "start"])
    var["end"] = var["start"] + 1000
    var.index = pd.Index([f"g{i}" for i in range(n_genes)])
    rng = np.random.default_rng(seed)
    per_row = max(1, int(n_genes * density))
    indptr = np.arange(n_cells + 1, dtype=np.int64) * per_row
    indices = rng.integers(0, n_genes, size=n_cells * per_row, dtype=np.int32)
    data = rng.normal(size=n_cells * per_row).astype(np.float32) ** 2
    expr = sp.csr_matrix((data, indices, indptr), shape=(n_cells, n_genes))
    expr.sum_duplicates()
    labels = np.array(["tumor"] * n_cells, dtype=object)
    labels[:40] = "normal_a"
    labels[40:80] = "normal_b"
    obs = pd.DataFrame({"cell_type": pd.Categorical(labels)}, index=[f"c{i}" for i in range(n_cells)])
    return tcnv.AnnData(X=expr, obs=obs, var=var)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bench_style_csr_batches_and_chunks(dtype):
    adata = _bench_adata()
    adata.X = adata.X.astype(dtype)
    kw = dict(reference_key="cell_type", reference_cat=["normal_a", "normal_b"], chunksize=128)
    (pos_t, got, _), (pos_j, want, _) = _both(adata, batch_cells=256, **kw)
    assert pos_t == pos_j
    assert got.shape == want.shape
    if dtype == np.float64:
        npt.assert_allclose(got.toarray(), want.toarray(), rtol=1e-9, atol=1e-12)
    else:
        kw.pop("chunksize")
        _assert_f32_close(got, want, _chunk_thresholds(adata, 128, **kw))


@pytest.mark.parametrize("batch_cells", [None, 128, 384])
def test_batching_does_not_change_the_result(batch_cells):
    adata = _bench_adata(n_cells=300)
    kw = dict(reference_key="cell_type", reference_cat=["normal_a", "normal_b"], chunksize=128)
    _, base, _ = tcnv.tl.infercnv(adata.copy(), inplace=False, device="cpu", **kw)
    _, got, _ = tcnv.tl.infercnv(adata.copy(), inplace=False, device="cpu", batch_cells=batch_cells, **kw)
    _assert_same_csr(got, base)


@pytest.mark.parametrize("device_densify", [True, False])
@pytest.mark.parametrize("compress_results", [True, False, None])
def test_densify_and_pack_switches_give_the_same_csr(compress_results, device_densify):
    adata = _bench_adata(n_cells=300)
    kw = dict(reference_key="cell_type", reference_cat=["normal_a", "normal_b"], chunksize=128)
    _, base, _ = tcnv.tl.infercnv(
        adata.copy(), inplace=False, device="cpu", device_densify=False, compress_results=False, **kw
    )
    _, got, _ = tcnv.tl.infercnv(
        adata.copy(), inplace=False, device="cpu", device_densify=device_densify, compress_results=compress_results,
        **kw,
    )
    _assert_same_csr(got, base)


def _no_cells(a):
    return a[:0]


def _dup_names(a):
    a.var.index = pd.Index(["g"] * a.n_vars)
    return a


def _no_positions(a):
    a.var = a.var.drop(columns=["start"])
    return a


BAD_INPUTS = [
    (_no_cells, {}),
    (_dup_names, {}),
    (_no_positions, {}),
    (lambda a: a, {"reference_key": "cell_type", "reference_cat": ["nope", "Microglia/Macrophage"]}),
    (lambda a: a, {"reference": np.zeros((1, 7))}),
]


@pytest.mark.parametrize("mutate,kw", BAD_INPUTS, ids=["no_cells", "dup_names", "no_positions", "bad_cat", "ref_width"])
def test_validation_messages_identical(oligo, mutate, kw):
    a_t = mutate(oligo.copy())
    a_j = cnv.AnnData(X=a_t.X.copy(), obs=a_t.obs.copy(), var=a_t.var.copy())
    with pytest.raises(ValueError) as want:
        cnv.tl.infercnv(a_j, mesh=False, **kw)
    with pytest.raises(ValueError) as got:
        tcnv.tl.infercnv(a_t, device="cpu", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "device,match",
    [(["cpu", "cuda:0"], "more than one type"), ([], "empty")],
    ids=["mixed_types", "empty_list"],
)
def test_bad_device_lists_raise(oligo, device, match):
    with pytest.raises(ValueError, match=match):
        tcnv.tl.infercnv(oligo.copy(), device=device)


@pytest.mark.parametrize("dtype", ["float16", np.int32, torch.bfloat16])
def test_rejects_compute_dtypes_other_than_f32_f64(oligo, dtype):
    with pytest.raises(ValueError, match="float32 or float64"):
        tcnv.tl.infercnv(oligo.copy(), dtype=dtype, device="cpu")


def test_inplace_slots_and_progress(oligo):
    adata = oligo.copy()
    seen = []
    tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=CATS, device="cpu", progress=seen.append)
    assert adata.obsm["X_cnv"].shape == (adata.n_obs, 180)
    assert list(adata.uns["cnv"]["chr_pos"])[0] == "chr1"
    assert seen and seen[-1]["cells_done"] == seen[-1]["cells_total"] == adata.n_obs
    assert set(seen[-1]) == {"cells_done", "cells_total", "elapsed_sec", "cells_per_sec", "eta_sec"}


def test_stats_keys():
    from infercnvpy_tpu_torch.tl._infercnv import _infercnv_compute

    adata = _bench_adata(n_cells=200)
    stats = {}
    _infercnv_compute(
        adata.X, adata.var, np.asarray(adata.X[:50].mean(axis=0)), lfc_clip=3, window_size=100, step=10,
        dynamic_threshold=1.5, chunksize=100, batch_cells=None, dtype=None, device=torch.device("cpu"), stats=stats,
    )
    assert {"host_pack_sec", "h2d_sec", "h2d_bytes", "compute_sec", "d2h_sec", "d2h_bytes", "csr_sec",
            "compile_sec", "mode", "result_pack"} <= set(stats)
    assert stats["mode"] == "device_densify" and stats["result_pack"] is True


def test_import_pulls_in_no_jax():
    code = (
        "import sys, infercnvpy_tpu_torch, infercnvpy_tpu_torch.tl._infercnv, infercnvpy_tpu_torch.ops.fused, "
        "infercnvpy_tpu_torch.ops.gene; "
        "assert 'jax' not in sys.modules and 'infercnvpy_tpu' not in sys.modules, sorted(sys.modules)"
    )
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300)


# ---------------------------------------------------------------------------
# calculate_gene_values=True
# ---------------------------------------------------------------------------


def _differential_adata(dtype=np.float64):
    """The end-to-end case of tests/test_reference_differential.py:231-250: genes
    without a position, chrX (excluded by default), small and regular chromosomes."""
    rng = np.random.default_rng(23)
    rows = []
    for chrom, g in [("chr2", 180), ("chr1", 120), ("chrX", 40), ("chr9", 60)]:
        rows += [(chrom, int(s), int(s) + 100) for s in np.sort(rng.integers(1, 10**7, size=g))]
    var = pd.DataFrame(rows, columns=["chromosome", "start", "end"])
    var.index = pd.Index([f"gene{i}" for i in range(len(var))])
    var.iloc[10:14, var.columns.get_loc("chromosome")] = None
    x = np.round(rng.normal(size=(33, len(var))) * 2, 3).astype(dtype)
    cats = np.array(["tumor", "normal"])[rng.integers(0, 2, 33)]
    obs = pd.DataFrame({"cell_type": pd.Categorical(cats)}, index=[f"c{i}" for i in range(33)])
    return tcnv.AnnData(X=x, obs=obs, var=var)


DIFF_KW = dict(reference_key="cell_type", reference_cat="normal", window_size=51, step=7, chunksize=13)


def _assert_gene_f32_close(got, want, row_thr):
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    covered = ~np.isnan(want)
    g, w = np.where(covered, got, 0), np.where(covered, want, 0)
    flip = (g == 0) != (w == 0)
    v = np.abs(np.where(g != 0, g, w))
    near = np.abs(v - row_thr[:, None]) <= FLIP_TOL
    assert near[flip].all(), f"{int((flip & ~near).sum())} gene gate flips away from the threshold"
    npt.assert_allclose(g[~flip], w[~flip], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gene_values_match_jax_differential_case(dtype):
    adata = _differential_adata(dtype)
    (pos_t, res_t, genes_t), (pos_j, res_j, genes_j) = _both(adata, calculate_gene_values=True, **DIFF_KW)
    assert pos_t == pos_j
    assert genes_t.shape == genes_j.shape == adata.shape
    assert genes_t.dtype == genes_j.dtype == dtype
    npt.assert_array_equal(np.isnan(genes_t), np.isnan(genes_j))
    # unannotated genes and chrX are NaN
    nan_cols = np.isnan(genes_t).all(axis=0)
    assert nan_cols[10:14].all() and nan_cols[(adata.var["chromosome"] == "chrX").values].all()
    if dtype == np.float64:
        npt.assert_allclose(res_t.toarray(), res_j.toarray(), rtol=1e-9, atol=1e-12)
        npt.assert_allclose(genes_t, genes_j, rtol=1e-9, atol=1e-12)
    else:
        kw = {k: v for k, v in DIFF_KW.items() if k != "chunksize"}
        thr = _chunk_thresholds(adata, DIFF_KW["chunksize"], **kw)
        _assert_f32_close(res_t, res_j, thr)
        _assert_gene_f32_close(genes_t, genes_j, thr)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gene_values_bench_style_batches_match_jax(dtype):
    adata = _bench_adata(n_cells=300)
    adata.X = adata.X.astype(dtype)
    kw = dict(reference_key="cell_type", reference_cat=["normal_a", "normal_b"])
    (_, res_t, genes_t), (_, _, genes_j) = _both(adata, calculate_gene_values=True, chunksize=128, batch_cells=256, **kw)
    assert genes_t.shape == adata.shape
    if dtype == np.float64:
        npt.assert_array_equal(np.isnan(genes_t), np.isnan(genes_j))
        npt.assert_allclose(genes_t, genes_j, rtol=1e-9, atol=1e-12)
    else:
        _assert_gene_f32_close(genes_t, genes_j, _chunk_thresholds(adata, 128, **kw))


def test_gene_values_inplace_layer_and_x_cnv_unchanged():
    adata = _differential_adata(np.float32)
    plain = adata.copy()
    tcnv.tl.infercnv(plain, device="cpu", **DIFF_KW)
    assert "gene_values_cnv" not in plain.layers
    tcnv.tl.infercnv(adata, device="cpu", calculate_gene_values=True, key_added="cnv", **DIFF_KW)
    layer = adata.layers["gene_values_cnv"]
    assert layer.shape == adata.shape and layer.dtype == np.float32
    _assert_same_csr(adata.obsm["X_cnv"], plain.obsm["X_cnv"])
    _, res, genes = tcnv.tl.infercnv(adata.copy(), inplace=False, device="cpu", calculate_gene_values=True, **DIFF_KW)
    _assert_same_csr(res, plain.obsm["X_cnv"])
    npt.assert_array_equal(genes, layer)


@pytest.mark.parametrize("dynamic_threshold", [1.5, None], ids=["gate", "nogate"])
def test_gene_values_do_not_depend_on_batching_or_result_pack(dynamic_threshold):
    adata = _bench_adata(n_cells=300)
    kw = dict(reference_key="cell_type", reference_cat=["normal_a", "normal_b"], chunksize=128,
              dynamic_threshold=dynamic_threshold, calculate_gene_values=True, inplace=False, device="cpu")
    _, res0, base = tcnv.tl.infercnv(adata.copy(), compress_results=False, **kw)
    for batch_cells, pack in [(None, True), (128, True), (256, None), (384, False)]:
        _, res, got = tcnv.tl.infercnv(adata.copy(), batch_cells=batch_cells, compress_results=pack, **kw)
        _assert_same_csr(res, res0)
        npt.assert_array_equal(got.view(np.uint32), base.view(np.uint32))


def test_result_pack_caps_are_per_matrix():
    """The gene matrix's packed capacity must not size the window matrix's fetch."""
    from infercnvpy_tpu_torch.tl._infercnv import _infercnv_compute

    adata = _bench_adata(n_cells=300)
    ref = np.asarray(adata.X[:80].mean(axis=0))
    kw = dict(lfc_clip=3, window_size=100, step=10, dynamic_threshold=1.5, chunksize=100, batch_cells=100,
              dtype=None, device=torch.device("cpu"))
    s_x, s_g = {}, {}
    _, r_x, none = _infercnv_compute(adata.X, adata.var, ref, stats=s_x, **kw)
    _, r_g, genes = _infercnv_compute(adata.X, adata.var, ref, stats=s_g, calculate_gene_values=True, **kw)
    assert none is None and genes.shape == adata.shape
    _assert_same_csr(r_g, r_x)
    assert s_g["d2h_bytes"] == s_x["d2h_bytes"]
    assert s_g["gene_d2h_bytes"] > 0
    assert {"gene_unpack_sec", "gene_scatter_sec"} <= set(s_g)


def test_default_device_needs_a_gpu_and_cpu_is_explicit(oligo, monkeypatch):
    """``device=None`` means the CUDA device: without one it raises and names ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(reference_key="cell_type", reference_cat=CATS)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcnv.tl.infercnv(oligo.copy(), **kw)
    adata = oligo.copy()
    tcnv.tl.infercnv(adata, device="cpu", **kw)
    assert adata.obsm["X_cnv"].shape == (adata.n_obs, 180)
