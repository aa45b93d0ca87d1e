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
    got = tcnv.tl.infercnv(a_t, inplace=False, **kw)
    want = cnv.tl.infercnv(a_j, inplace=False, mesh=False, **kw)
    return got, want


def _chunk_thresholds(adata_t, chunksize, dynamic_threshold=1.5, **kw):
    """Per-row gate threshold from the port's ungated result."""
    _, pre, _ = tcnv.tl.infercnv(adata_t.copy(), inplace=False, dynamic_threshold=None, chunksize=chunksize, **kw)
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
    _, base, _ = tcnv.tl.infercnv(adata.copy(), inplace=False, **kw)
    _, got, _ = tcnv.tl.infercnv(adata.copy(), inplace=False, batch_cells=batch_cells, **kw)
    _assert_same_csr(got, base)


@pytest.mark.parametrize("device_densify", [True, False])
@pytest.mark.parametrize("compress_results", [True, False, None])
def test_densify_and_pack_switches_give_the_same_csr(compress_results, device_densify):
    adata = _bench_adata(n_cells=300)
    kw = dict(reference_key="cell_type", reference_cat=["normal_a", "normal_b"], chunksize=128)
    _, base, _ = tcnv.tl.infercnv(adata.copy(), inplace=False, device_densify=False, compress_results=False, **kw)
    _, got, _ = tcnv.tl.infercnv(
        adata.copy(), inplace=False, device_densify=device_densify, compress_results=compress_results, **kw
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
        tcnv.tl.infercnv(a_t, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "kw,item",
    [
        ({"calculate_gene_values": True}, "gene values"),
        ({"checkpoint_dir": "ckpt"}, "checkpoint/resume"),
        ({"transfer_dtype": "bfloat16"}, "transfer_dtype"),
        ({"device": ["cpu", "cpu"]}, "multi-device"),
    ],
    ids=["gene_values", "checkpoint", "transfer_dtype", "multi_device"],
)
def test_unported_options_raise(oligo, kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md: {item}"):
        tcnv.tl.infercnv(oligo.copy(), **kw)


@pytest.mark.parametrize("dtype", ["float16", np.int32, torch.bfloat16])
def test_rejects_compute_dtypes_other_than_f32_f64(oligo, dtype):
    with pytest.raises(ValueError, match="float32 or float64"):
        tcnv.tl.infercnv(oligo.copy(), dtype=dtype)


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
        "import sys, infercnvpy_tpu_torch, infercnvpy_tpu_torch.tl._infercnv, infercnvpy_tpu_torch.ops.fused; "
        "assert 'jax' not in sys.modules and 'infercnvpy_tpu' not in sys.modules, sorted(sys.modules)"
    )
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300)
