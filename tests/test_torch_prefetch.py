"""The pipelined copy stream and ``transfer_dtype`` of the port's ``tl.infercnv``.

Mirrors ``tests/test_pipeline.py:66-118``: with more than one batch to
compute and no ``stats``, a worker thread packs batch k+1 while batch k
computes and batch k-1 is assembled; the result must equal the serialized
(``stats``) run bit for bit.  ``transfer_dtype`` rounds the shipped values
once, so a run's error stays within 1 % of the result's scale (the bound of
the JAX package's test), and the port's bf16 run matches the JAX package's
bf16 run to the whole-run f32 bars (rtol 1e-5, atol 1e-5; an entry may be
gated in one and not the other only within 1e-5 of its chunk's threshold).
Cases marked ``cuda`` need neither JAX nor the JAX package:

    python -m pytest tests/test_torch_prefetch.py -m cuda --noconftest -p no:cacheprovider
"""

import sys

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import infercnvpy_tpu_torch.tl as tcnv_tl  # noqa: E402
import infercnvpy_tpu_torch.tl._infercnv as drv  # noqa: E402
from infercnvpy_tpu_torch.tl._infercnv import _infercnv_compute  # noqa: E402

FLIP_TOL = 1e-5


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


def _toy(n_cells=96, n_genes=600, seed=0):
    """tests/test_pipeline.py's toy input."""
    rng = np.random.default_rng(seed)
    rows = []
    for c in range(4):
        starts = np.sort(rng.integers(1, 2**27, size=n_genes // 4))
        rows += [(f"chr{c + 1}", int(s)) for s in starts]
    var = pd.DataFrame(rows, columns=["chromosome", "start"])
    var["end"] = var["start"] + 1000
    expr = sp.random(n_cells, n_genes, density=0.08, format="csr", dtype=np.float32, random_state=seed)
    ref = np.asarray(expr[: n_cells // 4].mean(axis=0), dtype=np.float64)
    return expr, var, ref


KW = dict(lfc_clip=3.0, window_size=50, step=10, dynamic_threshold=1.5, chunksize=16, batch_cells=32,
          dtype=np.float32)


def _run(expr, var, ref, device="cpu", **kw):
    return _infercnv_compute(expr, var, ref, device=torch.device(device), **{**KW, **kw})


def _same_csr(a, b):
    assert a.shape == b.shape
    npt.assert_array_equal(a.indptr, b.indptr)
    npt.assert_array_equal(a.indices, b.indices)
    npt.assert_array_equal(a.data.view(np.uint32 if a.data.itemsize == 4 else np.uint64),
                           b.data.view(np.uint32 if b.data.itemsize == 4 else np.uint64))


CASES = [
    ("sparse", {}),
    ("sparse", {"device_densify": False}),
    ("dense", {}),
    ("sparse", {"calculate_gene_values": True}),
    ("sparse", {"compress_results": False, "dynamic_threshold": None}),
    ("sparse", {"transfer_dtype": "bfloat16"}),
    ("dense", {"transfer_dtype": "float16"}),
    ("sparse", {"dtype": np.float64}),
]
CASE_IDS = ["sparse", "host_pack_csr", "dense", "gene_values", "dense_fetch", "bf16", "dense_f16", "f64"]


def _pipelined_vs_serialized(device, fmt, kw):
    expr, var, ref = _toy(n_cells=128, seed=2)
    if fmt == "dense":
        expr = np.asarray(expr.todense())
    stats = {}
    _, serialized, g_ser = _run(expr, var, ref, device, stats=stats, **kw)
    _, pipelined, g_pipe = _run(expr, var, ref, device, **kw)
    _same_csr(serialized, pipelined)
    if kw.get("calculate_gene_values"):
        npt.assert_array_equal(g_ser.view(np.uint32), g_pipe.view(np.uint32))
    return stats


@pytest.mark.parametrize("fmt,kw", CASES, ids=CASE_IDS)
def test_pipelined_matches_serialized(fmt, kw):
    _pipelined_vs_serialized("cpu", fmt, kw)


def test_pipeline_uses_a_worker_only_without_stats(monkeypatch):
    expr, var, ref = _toy(n_cells=96)
    made = []
    real = drv.ThreadPoolExecutor

    def counting(*a, **k):
        made.append(k.get("thread_name_prefix"))
        return real(*a, **k)

    monkeypatch.setattr(drv, "ThreadPoolExecutor", counting)
    _run(expr, var, ref, stats={})
    _run(expr, var, ref, batch_cells=96)  # one batch: nothing to overlap
    assert made == []
    _run(expr, var, ref)
    assert made == ["infercnv-pack"]


def test_worker_errors_reach_the_caller(monkeypatch):
    import infercnvpy_tpu_torch.ops.sparse_ingest as si

    expr, var, ref = _toy(n_cells=96)
    real = si.coo_from_csr_batch
    calls = []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("pack failed")
        return real(*a, **k)

    monkeypatch.setattr(si, "coo_from_csr_batch", failing)
    with pytest.raises(RuntimeError, match="pack failed"):
        _run(expr, var, ref)


def test_pipeline_stress_many_batches():
    """Many small batches with a short interpreter switch interval: the two
    host slots are reused 20 times while the worker and the main thread run
    side by side; a lost or overwritten batch would change the result."""
    expr, var, ref = _toy(n_cells=640, seed=4)
    _, serialized, _ = _run(expr, var, ref, stats={}, calculate_gene_values=True)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _, pipelined, _ = _run(expr, var, ref, calculate_gene_values=True)
    finally:
        sys.setswitchinterval(prev)
    _same_csr(serialized, pipelined)


def test_progress_callback_per_batch():
    expr, var, ref = _toy(n_cells=96)
    events = []
    _run(expr, var, ref, progress=events.append)
    assert len(events) == 3  # 96 cells / 32 batch_cells
    assert [e["cells_done"] for e in events] == [32, 64, 96]
    assert all(e["cells_total"] == 96 for e in events)
    assert events[-1]["eta_sec"] == pytest.approx(0.0, abs=1e-6)
    assert all(e["cells_per_sec"] > 0 for e in events)


def test_progress_stderr_line(capsys):
    expr, var, ref = _toy(n_cells=64)
    _run(expr, var, ref, progress=True)
    err = capsys.readouterr().err
    assert "infercnv: 32/64 cells" in err and "infercnv: 64/64 cells" in err


@pytest.mark.parametrize("transfer", ["bfloat16", "bf16", "float16"])
@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_transfer_dtype_error_bound_and_bytes(mode, transfer):
    expr, var, ref = _toy(n_cells=128, seed=5)
    if mode == "dense":
        expr = np.asarray(expr.todense())
    s32, sred = {}, {}
    _, full, _ = _run(expr, var, ref, stats=s32, dynamic_threshold=None)
    _, red, _ = _run(expr, var, ref, stats=sred, dynamic_threshold=None, transfer_dtype=transfer)
    full = full.toarray()
    red = red.toarray()
    assert np.abs(red - full).max() <= 0.01 * np.abs(full).max() + 1e-4
    assert not np.array_equal(red, full)  # the values really were rounded
    assert sred["h2d_bytes"] < s32["h2d_bytes"]
    if mode == "dense":
        assert sred["h2d_bytes"] <= 0.55 * s32["h2d_bytes"]
    assert sred["transfer_dtype"] == ("bfloat16" if transfer == "bf16" else transfer)


@pytest.mark.parametrize("transfer", ["int8", "complex64"])
def test_transfer_dtype_rejects_non_floats_like_jax(transfer):
    from infercnvpy_tpu.tl._infercnv import _transfer_np_dtype

    expr, var, ref = _toy(n_cells=32)
    with pytest.raises(ValueError) as want:
        _transfer_np_dtype(transfer)
    with pytest.raises(ValueError) as got:
        _run(expr, var, ref, transfer_dtype=transfer)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_bf16_run_matches_jax_bf16_run(mode):
    from infercnvpy_tpu.tl._infercnv import _infercnv_compute as jax_compute

    expr, var, ref = _toy(n_cells=128, seed=7)
    if mode == "dense":
        expr = np.asarray(expr.todense())
    kw = {k: v for k, v in KW.items()}
    _, got, _ = _run(expr, var, ref, transfer_dtype="bfloat16")
    _, want, _ = jax_compute(expr, var, ref, mesh=False, calculate_gene_values=False, transfer_dtype="bfloat16", **kw)
    # per-row gate thresholds from the port's ungated bf16 run
    _, pre, _ = _run(expr, var, ref, transfer_dtype="bfloat16", dynamic_threshold=None)
    pre = pre.toarray().astype(np.float64)
    thr = np.empty(pre.shape[0])
    for s in range(0, pre.shape[0], KW["chunksize"]):
        thr[s : s + KW["chunksize"]] = KW["dynamic_threshold"] * pre[s : s + KW["chunksize"]].std()
    g, w = got.toarray(), want.toarray()
    flip = (g == 0) != (w == 0)
    v = np.abs(np.where(g != 0, g, w))
    assert (np.abs(v - thr[:, None]) <= FLIP_TOL)[flip].all()
    npt.assert_allclose(g[~flip], w[~flip], rtol=1e-5, atol=1e-5)


def test_clear_transform_caches():
    from infercnvpy_tpu_torch.ops import gene

    expr, var, ref = _toy(n_cells=64)
    _run(expr, var, ref, calculate_gene_values=True)
    assert gene._gpd_cache
    tcnv_tl.clear_transform_caches()
    assert not gene._gpd_cache
    _, res, genes = _run(expr, var, ref, calculate_gene_values=True)
    assert res.shape[0] == genes.shape[0] == 64


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,kw", CASES, ids=CASE_IDS)
def test_pipelined_matches_serialized_on_gpu(cuda, fmt, kw):
    stats = _pipelined_vs_serialized(cuda, fmt, kw)
    assert stats["mode"] == ("device_densify" if fmt == "sparse" and kw.get("device_densify") is not False
                             else "host_pack")


@pytest.mark.cuda
@pytest.mark.parametrize("transfer", ["bfloat16", "float16"])
@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_transfer_dtype_on_gpu_matches_cpu(cuda, mode, transfer):
    """The same rounded inputs on both devices: the fused kernel against the
    plain pipeline, at the kernel's bars (rtol 1e-5, atol 1e-6), gate off."""
    expr, var, ref = _toy(n_cells=128, seed=5)
    if mode == "dense":
        expr = np.asarray(expr.todense())
    kw = dict(dynamic_threshold=None, transfer_dtype=transfer)
    _, gpu, _ = _run(expr, var, ref, cuda, **kw)
    _, cpu, _ = _run(expr, var, ref, "cpu", **kw)
    npt.assert_allclose(gpu.toarray(), cpu.toarray(), rtol=1e-5, atol=1e-6)
