"""The port's device pipeline against the JAX package: transform, device densify, result pack."""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from infercnvpy_tpu.genome import build_window_plan as jax_build_plan  # noqa: E402
from infercnvpy_tpu.ops import infercnv_kernel as jik  # noqa: E402
from infercnvpy_tpu.ops import result_pack as jrp  # noqa: E402
from infercnvpy_tpu_torch.genome import build_window_plan  # noqa: E402
from infercnvpy_tpu_torch.ops import infercnv_kernel as tik  # noqa: E402
from infercnvpy_tpu_torch.ops import result_pack as trp  # noqa: E402
from infercnvpy_tpu_torch.ops import sparse_ingest as tsi  # noqa: E402

# tests/test_reference_differential.py CONFIGS: (chrom spec, n_cells, window, step, n_ref, lfc_clip)
CONFIGS = [
    ([("chr1", 220), ("chr2", 150), ("chr3", 40)], 23, 100, 10, 2, 3.0),
    ([("chr1", 130), ("chr7", 7), ("chr11", 90)], 17, 11, 3, 1, 1.0),
    ([("chr2", 64), ("chrM", 10), ("weird", 5), ("chr10", 101)], 9, 25, 5, 3, 2.0),
    ([("chr1", 99), ("chr2", 100)], 11, 100, 10, 2, 3.0),
    ([("chr1", 300)], 8, 50, 1, 2, 3.0),
    ([("chr1", 120), ("chr2", 60)], 12, 30, 30, 1, 3.0),
    ([("chr1", 50), ("chr2", 50)], 10, 50, 10, 2, 3.0),
]
IDS = ["3chrom", "w11s3", "chrM_weird", "all_small", "step1", "window_eq_step", "g_eq_window"]
CHUNK = 5
N_PAD = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _make_var(rng, spec):
    rows = []
    for chrom, g in spec:
        for s in np.sort(rng.integers(1, 10**7, size=g)):
            rows.append((chrom, int(s), int(s) + 100))
    var = pd.DataFrame(rows, columns=["chromosome", "start", "end"])
    var.index = pd.Index([f"gene{i}" for i in range(len(var))])
    return var


def _case(cfg, dtype, seed=0):
    """Packed inputs for both packages: real rows in chunks of CHUNK, then padding rows."""
    spec, n_cells, window, step, n_ref, clip = cfg
    rng = np.random.default_rng(seed)
    var = _make_var(rng, spec)
    jplan = jax_build_plan(var, window, step)
    tplan = build_window_plan(var, window, step)
    lut = jik._pack_lut(jplan, len(var))
    x = np.round(rng.normal(size=(n_cells + N_PAD, len(var))) * 2, 3)
    x[n_cells:] = 0
    ref = np.round(rng.normal(size=(n_ref, len(var))), 3)
    xp = jik.pack_columns(x.astype(dtype), jplan, lut)
    refp = jik.pack_columns(ref.astype(dtype), jplan, lut)
    num_chunks = -(-n_cells // CHUNK)
    cid = np.arange(n_cells + N_PAD) // CHUNK
    cid[n_cells:] = num_chunks
    return jplan, tplan, xp, refp, cid, num_chunks, n_ref, clip, n_cells


@pytest.mark.parametrize("gate", [1.5, None], ids=["gate", "nogate"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_f64_transform_matches_jax(cfg, gate):
    jplan, tplan, xp, refp, cid, num_chunks, n_ref, clip, n_cells = _case(cfg, np.float64)
    kw = dict(n_ref_rows=n_ref, lfc_clip=clip, dynamic_threshold=gate, num_chunks=num_chunks)
    want, _ = jik.build_infercnv_fn(jplan, dtype=jnp.float64, **kw)(xp, refp, cid.astype(np.int32))
    got, gene = tik.build_infercnv_fn(tplan, dtype=torch.float64, **kw)(
        torch.from_numpy(xp), torch.from_numpy(refp), torch.from_numpy(cid)
    )
    assert gene is None
    assert got.dtype == torch.float64
    npt.assert_allclose(got.numpy()[:n_cells], np.asarray(want)[:n_cells], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_f32_transform_matches_jax_fused(cfg):
    """f32 on the CPU runs the fused step's plain version; JAX runs its Pallas kernel interpreted."""
    jplan, tplan, xp, refp, cid, num_chunks, n_ref, clip, n_cells = _case(cfg, np.float32, seed=1)
    kw = dict(n_ref_rows=n_ref, lfc_clip=clip, dynamic_threshold=None, num_chunks=num_chunks)
    want, _ = jik.build_infercnv_fn(jplan, dtype=jnp.float32, smooth_mode="fused", row_tile=8, **kw)(
        xp, refp, cid.astype(np.int32)
    )
    got, _ = tik.build_infercnv_fn(tplan, dtype=torch.float32, **kw)(
        torch.from_numpy(xp), torch.from_numpy(refp), torch.from_numpy(cid)
    )
    assert got.dtype == torch.float32
    npt.assert_allclose(got.numpy()[:n_cells], np.asarray(want)[:n_cells], rtol=1e-5, atol=1e-6)


def test_chunk_gate_rejects_unsorted_ids():
    x = torch.ones(3, 4)
    s = x.sum(1)
    with pytest.raises(ValueError, match="sorted"):
        tik.chunk_gate(x, s, s, torch.tensor([1, 0, 1]), 2, 1.5)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        tik.chunk_gate(x, s, s, torch.tensor([0, 1, 2]), 1, 1.5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cfg", CONFIGS[:3] + CONFIGS[4:5], ids=IDS[:3] + IDS[4:5])
def test_device_densify_equals_pack_csr(cfg, dtype):
    spec = cfg[0]
    rng = np.random.default_rng(3)
    var = _make_var(rng, spec)
    plan = build_window_plan(var, cfg[2], cfg[3])
    lut = tik._pack_lut(plan, len(var))
    width = tik.packed_width(plan)
    x = rng.normal(size=(14, len(var))).astype(np.float32)
    x[rng.random(x.shape) < 0.8] = 0
    x[2] = 0
    x[5, :3] = -0.0
    csr = sp.csr_matrix(x)
    n_pad = 4
    cols, vals, counts, nnz = tsi.coo_from_csr_batch(csr, lut, width, csr.nnz + 100, val_dtype=dtype)
    counts = np.concatenate([counts, np.zeros(n_pad, np.int32)])
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    dense = tsi.densify(torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(counts), nnz, width, tdtype)
    want = tik.pack_csr(csr, plan, lut, dtype=dtype)
    got = dense.numpy()
    assert got.shape == (14 + n_pad, width)
    assert got.dtype == want.dtype
    npt.assert_array_equal(got[:14].view(np.uint8), want.view(np.uint8))
    assert not got[14:].any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("width", [1, 31, 32, 33, 180, 1793])
def test_result_pack_matches_dense_csr(width, dtype):
    rng = np.random.default_rng(width)
    rows, n_pad = 29, 3
    x = rng.normal(size=(rows + n_pad, width)).astype(dtype)
    x[np.abs(x) < 1.0] = 0  # the gate
    x[4] = 0
    x[rows:] = 7.0  # padding rows pass the gate dense and must be dropped
    xt = torch.from_numpy(x)
    mask, nnz = trp.mask_nnz(xt, rows)
    cap = trp.round_result_cap(nnz)
    vals = trp.compact(xt, rows, cap)
    assert vals.shape == (cap,)
    mask_np = mask.numpy().view(np.uint32)
    # the same word mask as the JAX package's mask_nnz_fn
    jmask, jnnz = jrp.mask_nnz_fn(width)(x, np.int32(rows))
    assert int(jnnz) == nnz
    npt.assert_array_equal(mask_np, np.asarray(jmask)[:rows])
    got = trp.mask_vals_to_csr(mask_np, vals.numpy()[:nnz], width)
    want = sp.csr_matrix(x[:rows])
    assert got.shape == want.shape
    npt.assert_array_equal(got.indptr, want.indptr)
    npt.assert_array_equal(got.indices, want.indices)
    assert got.data.dtype == want.data.dtype
    npt.assert_array_equal(got.data.view(np.uint8), want.data.view(np.uint8))


@pytest.mark.parametrize("nnz", [0, 1, 1024, 1025, 70_000])
def test_round_result_cap_equal(nnz):
    assert trp.round_result_cap(nnz) == jrp.round_result_cap(nnz)
