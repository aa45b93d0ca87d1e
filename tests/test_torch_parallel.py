"""Cell shards of the PyTorch port (``infercnvpy_tpu_torch.parallel``) against one device and the JAX mesh path.

The port gathers every shard's per-row sums and takes the one-device chunk
threshold on their concatenation, so ``device=["cpu"] * n`` must give the
bits of ``device="cpu"``.  Against the JAX package's mesh path (the virtual
8-device CPU mesh of ``tests/conftest.py``) the bars are the port's: f64 at
rtol 1e-9 / atol 1e-12, f32 at rtol 1e-5 / atol 1e-5 (gate flips only within
1e-5 of the threshold), gene values with the same NaN pattern; the
downstream ops at ``tests/test_mesh_downstream.py``'s tolerances.

Cases marked ``cuda`` run two shards on one card against the card alone;
they need neither JAX nor the JAX package:

    python -m pytest tests/test_torch_parallel.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import infercnvpy_tpu_torch as tcnv  # noqa: E402
from infercnvpy_tpu_torch import parallel  # noqa: E402
from infercnvpy_tpu_torch._util import pick_devices  # noqa: E402
from infercnvpy_tpu_torch.genome import build_window_plan  # noqa: E402
from infercnvpy_tpu_torch.ops import result_pack as trp  # noqa: E402
from infercnvpy_tpu_torch.ops.infercnv_kernel import _pack_lut, build_infercnv_fn, pack_columns  # noqa: E402
from infercnvpy_tpu_torch.tl._infercnv import _LAST_RUN_INFO  # noqa: E402

CATS = ["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"]
SHARDS = [1, 2, 3, 8]
REPS = {"dense": lambda x: x.toarray(), "csr": sp.csr_matrix, "csc": sp.csc_matrix}
# chunks of 7 cross the shards of every count; batches of 16 cells (whole
# chunks: 14) pad the last batch; chunks of 16 against 61-row shards of 183
OPTIONS = {
    "chunk7_batch16": dict(chunksize=7, batch_cells=16),
    "chunk16": dict(chunksize=16),
    "gene_values": dict(chunksize=7, calculate_gene_values=True),
    "dense_fetch": dict(chunksize=7, compress_results=False),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def oligo():
    return tcnv.datasets.oligodendroglioma()


def _run(adata, device, rep="csr", **kw):
    a = adata.copy()
    a.X = REPS[rep](sp.csr_matrix(adata.X))
    out = tcnv.tl.infercnv(a, reference_key="cell_type", reference_cat=CATS, device=device, inplace=False, **kw)
    return out, dict(_LAST_RUN_INFO)


def _assert_bits(a, b):
    """Two ``tl.infercnv`` results, CSR window matrix and gene layer, equal bit for bit."""
    (pa, ra, ga), (pb, rb, gb) = a, b
    assert pa == pb
    assert ra.shape == rb.shape and ra.dtype == rb.dtype
    npt.assert_array_equal(ra.indptr, rb.indptr)
    npt.assert_array_equal(ra.indices, rb.indices)
    npt.assert_array_equal(ra.data.view(np.uint8), rb.data.view(np.uint8))
    assert (ga is None) == (gb is None)
    if ga is not None:
        npt.assert_array_equal(np.ascontiguousarray(ga).view(np.uint8), np.ascontiguousarray(gb).view(np.uint8))


_ONE_DEVICE: dict = {}


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("rep", list(REPS))
def test_shards_bit_identical_to_one_device(oligo, rep, option, n):
    key = (rep, option)
    if key not in _ONE_DEVICE:
        _ONE_DEVICE[key] = _run(oligo, "cpu", rep, **OPTIONS[option])[0]
    got, info = _run(oligo, ["cpu"] * n, rep, **OPTIONS[option])
    _assert_bits(got, _ONE_DEVICE[key])
    assert info == {"n_devices": n, "sharded": n > 1, "device_densify": rep != "dense" and n == 1}


def test_device_densify_on_shards_warns_and_packs_on_the_host(oligo, capsys):
    got, info = _run(oligo, ["cpu"] * 2, "csr", chunksize=7, device_densify=True)
    assert "device_densify is not supported on several devices" in capsys.readouterr().err
    assert info == {"n_devices": 2, "sharded": True, "device_densify": False}
    _assert_bits(got, _run(oligo, "cpu", "csr", chunksize=7)[0])


def test_checkpoint_written_on_one_device_resumes_on_three(oligo, tmp_path):
    kw = dict(chunksize=7, batch_cells=28, calculate_gene_values=True)
    whole, _ = _run(oligo, "cpu", checkpoint_dir=tmp_path, **kw)
    files = sorted(tmp_path.glob("batch_*.npz"))
    assert len(files) == 7
    for f in files[1::2]:
        f.unlink()
    resumed, info = _run(oligo, ["cpu"] * 3, checkpoint_dir=tmp_path, **kw)
    assert info["n_devices"] == 3
    _assert_bits(resumed, whole)
    assert len(list(tmp_path.glob("batch_*.npz"))) == 7


@pytest.mark.parametrize(
    "device,error,match",
    [
        ([], ValueError, "empty"),
        (["cpu", "cuda:0"], ValueError, "more than one type"),
        (("cpu", torch.device("meta")), ValueError, "more than one type"),
    ],
    ids=["empty", "cpu_cuda", "cpu_meta"],
)
def test_pick_devices_rejects(device, error, match):
    with pytest.raises(error, match=match):
        pick_devices(device, "test")


def test_pick_devices_lists_and_none():
    assert pick_devices("cpu", "t") == [torch.device("cpu")]
    assert pick_devices(("cpu", torch.device("cpu")), "t") == [torch.device("cpu")] * 2
    assert parallel.cell_mesh(["cpu"] * 3) == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            pick_devices(None, "t")


@pytest.mark.parametrize("n,n_dev", [(0, 1), (1, 3), (7, 2), (16, 8), (183, 3), (183, 8)])
def test_shard_rows_and_pad_rows(n, n_dev):
    ranges = parallel.shard_rows(n, n_dev)
    assert len(ranges) == n_dev and ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [b - a for a, b in ranges]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)
    padded = parallel.pad_rows(np.ones((n, 3), np.float32), n_dev)
    assert padded.shape == (n + (-n) % n_dev, 3) and not padded[n:].any()
    if n % n_dev == 0:
        assert sizes == [n // n_dev] * n_dev


def test_replicate_one_copy_per_distinct_device_and_mesh_key():
    t = torch.arange(5)
    copies = parallel.replicate(t, ["cpu", "cpu", torch.device("cpu")])
    assert len(copies) == 3 and all(c is copies[0] for c in copies)
    assert parallel.mesh_key(["cpu", torch.device("cpu")]) == ("cpu", "cpu")


@pytest.fixture(scope="module")
def problem():
    """tests/test_parallel.py's problem: 64 cells, 200 genes on 3 chromosomes, window 15 / step 4."""
    rng = np.random.default_rng(0)
    n_cells, n_genes = 64, 200
    var = pd.DataFrame({
        "chromosome": ["chr1"] * 120 + ["chr2"] * 60 + ["chr3"] * 20,
        "start": list(range(120)) + list(range(60)) + list(range(20)),
    })
    var["end"] = var["start"] + 1
    x = rng.normal(size=(n_cells, n_genes))
    ref = rng.normal(size=(2, n_genes))
    chunk_ids = (np.arange(n_cells) // 16).astype(np.int32)
    return var, x, ref, chunk_ids


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("genes", [False, True], ids=["windows", "gene_values"])
def test_run_sharded_equals_one_device(problem, n, genes):
    var, x, ref, chunk_ids = problem
    plan = build_window_plan(var, 15, 4)
    lut = _pack_lut(plan, x.shape[1])
    xp = pack_columns(x.astype(np.float32), plan, lut)
    rp = pack_columns(ref.astype(np.float32), plan, lut)
    kw = dict(n_ref_rows=2, lfc_clip=3.0, dynamic_threshold=1.5, num_chunks=4, calculate_gene_values=genes)
    want_x, want_g = build_infercnv_fn(plan, **kw)(torch.from_numpy(xp), torch.from_numpy(rp),
                                                   torch.from_numpy(chunk_ids))
    fn = parallel.sharded_infercnv_fn(plan, ["cpu"] * n, **kw)
    assert parallel.sharded_infercnv_fn(plan, ["cpu"] * n, **kw) is fn  # cached
    got_x, got_g = parallel.run_sharded_infercnv(fn, ["cpu"] * n, xp, rp, chunk_ids)
    npt.assert_array_equal(got_x.view(np.uint32), want_x.numpy().view(np.uint32))
    assert (got_x == 0).any()
    if genes:
        npt.assert_array_equal(got_g.view(np.uint32), want_g.numpy().view(np.uint32))
    else:
        assert got_g is None


@pytest.mark.parametrize("genes", [False, True], ids=["windows", "gene_values"])
def test_sharded_fn_matches_jax_sharded_fn_f64(problem, genes):
    import jax
    import jax.numpy as jnp

    from infercnvpy_tpu.genome import build_window_plan as jax_plan
    from infercnvpy_tpu.ops.infercnv_kernel import _pack_lut as jax_lut, pack_columns as jax_pack
    from infercnvpy_tpu.parallel import cell_mesh, replicate, shard_cells
    from infercnvpy_tpu.parallel.sharded import sharded_infercnv_fn as jax_sharded

    var, x, ref, chunk_ids = problem
    kw = dict(n_ref_rows=2, lfc_clip=3.0, dynamic_threshold=1.5, num_chunks=4, calculate_gene_values=genes)
    jplan = jax_plan(var, 15, 4)
    jl = jax_lut(jplan, x.shape[1])
    mesh = cell_mesh()
    assert mesh.devices.size == 8
    want_x, want_g = jax_sharded(jplan, mesh, dtype=jnp.float64, **kw)(
        jax.device_put(jax_pack(x, jplan, jl), shard_cells(mesh)),
        jax.device_put(jax_pack(ref, jplan, jl), replicate(mesh)),
        jax.device_put(chunk_ids, shard_cells(mesh)),
    )
    plan = build_window_plan(var, 15, 4)
    lut = _pack_lut(plan, x.shape[1])
    fn = parallel.sharded_infercnv_fn(plan, ["cpu"] * 8, dtype=torch.float64, **kw)
    got_x, got_g = parallel.run_sharded_infercnv(
        fn, ["cpu"] * 8, pack_columns(x, plan, lut), pack_columns(ref, plan, lut), chunk_ids
    )
    npt.assert_allclose(got_x, np.asarray(want_x), rtol=1e-9, atol=1e-12)
    if genes:
        want_g = np.asarray(want_g)
        npt.assert_array_equal(np.isnan(got_g), np.isnan(want_g))
        npt.assert_allclose(got_g, want_g, rtol=1e-9, atol=1e-12)


def _jax_adata(adata_t, X):
    import infercnvpy_tpu as cnv

    return cnv.AnnData(X=X, obs=adata_t.obs.copy(), var=adata_t.var.copy())


@pytest.mark.parametrize("genes", [False, True], ids=["windows", "gene_values"])
def test_shards_match_jax_mesh_f64(oligo, genes):
    import infercnvpy_tpu as cnv
    from infercnvpy_tpu.tl._infercnv import _LAST_RUN_INFO as JAX_INFO

    X = sp.csr_matrix(oligo.X).astype(np.float64)
    kw = dict(reference_key="cell_type", reference_cat=CATS, chunksize=7, inplace=False,
              calculate_gene_values=genes)
    a = oligo.copy()
    a.X = X
    pos, got, got_g = tcnv.tl.infercnv(a, device=["cpu"] * 8, **kw)
    info = dict(_LAST_RUN_INFO)
    jpos, want, want_g = cnv.tl.infercnv(_jax_adata(oligo, X), **kw)
    assert info == JAX_INFO == {"n_devices": 8, "sharded": True, "device_densify": False}
    assert pos == jpos
    npt.assert_allclose(got.toarray(), want.toarray(), rtol=1e-9, atol=1e-12)
    if genes:
        npt.assert_array_equal(np.isnan(got_g), np.isnan(want_g))
        m = ~np.isnan(want_g)
        npt.assert_allclose(got_g[m], want_g[m], rtol=1e-9, atol=1e-12)


def test_shards_match_jax_mesh_f32(oligo):
    import infercnvpy_tpu as cnv

    X = sp.csr_matrix(oligo.X).astype(np.float32)
    kw = dict(reference_key="cell_type", reference_cat=CATS, chunksize=16, inplace=False, dtype=np.float32)
    a = oligo.copy()
    a.X = X
    _, got, _ = tcnv.tl.infercnv(a, device=["cpu"] * 8, **kw)
    _, want, _ = cnv.tl.infercnv(_jax_adata(oligo, X), **kw)
    _, pre, _ = tcnv.tl.infercnv(a, device="cpu", **{**kw, "dynamic_threshold": None})
    pre = pre.toarray().astype(np.float64)
    thr = np.concatenate([np.full(len(pre[s : s + 16]), 1.5 * pre[s : s + 16].std()) for s in range(0, len(pre), 16)])
    g, w = got.toarray(), want.toarray()
    flip = (g == 0) != (w == 0)
    near = np.abs(np.abs(np.where(g != 0, g, w)) - thr[:, None]) <= 1e-5
    assert near[flip].all(), f"{int((flip & ~near).sum())} gate flips away from the threshold"
    npt.assert_allclose(g[~flip], w[~flip], rtol=1e-5, atol=1e-5)


def test_last_run_info_keys_equal_jax(oligo):
    import infercnvpy_tpu as cnv
    from infercnvpy_tpu.tl._infercnv import _LAST_RUN_INFO as JAX_INFO

    _, info = _run(oligo, "cpu")
    cnv.tl.infercnv(_jax_adata(oligo, sp.csr_matrix(oligo.X)), reference_key="cell_type", reference_cat=CATS,
                    inplace=False, mesh=False)
    assert info == JAX_INFO == {"n_devices": 1, "sharded": False, "device_densify": True}


def _sharded_pack_inputs():
    """8 shards of 40 rows × 70 windows; 300 valid rows (padding at the tail), shard 2 without
    survivors, shard 5 above the 1,024-value floor capacity."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(320, 70)).astype(np.float32)
    x[rng.random(x.shape) < 0.8] = 0
    x[80:120] = 0
    x[200:240] = rng.normal(size=(40, 70)).astype(np.float32) + 10.0
    return x, 300


def test_sharded_pack_equals_jax_and_dense():
    import jax

    from infercnvpy_tpu.ops import result_pack as jrp
    from infercnvpy_tpu.parallel import cell_mesh, shard_cells

    x, n_valid = _sharded_pack_inputs()
    xs = [torch.from_numpy(x[a:b]) for a, b in parallel.shard_rows(len(x), 8)]
    masks, nnz = trp.sharded_mask_nnz(xs, n_valid)
    assert nnz[2] == 0 and nnz[5] == 40 * 70 > 1024
    cap = trp.round_result_cap(max(nnz))
    vals = torch.cat(trp.sharded_compact(xs, n_valid, cap)).numpy()
    mask = torch.cat(masks).numpy().view(np.uint32)
    got = trp.sharded_mask_vals_to_csr(mask, vals, nnz, 70)

    mesh = cell_mesh()
    xd = jax.device_put(x, shard_cells(mesh))
    jmask, jnnz = jrp.sharded_mask_nnz_fn(mesh, 70)(xd, np.int32(n_valid))
    jvals = np.asarray(jrp.sharded_compact_fn(mesh, cap)(xd, np.int32(n_valid)))
    npt.assert_array_equal(np.asarray(jnnz), nnz)
    npt.assert_array_equal(np.asarray(jmask)[:n_valid], mask)
    npt.assert_array_equal(jvals, vals)
    want = jrp.sharded_mask_vals_to_csr(mask, vals, np.asarray(jnnz), 70)
    dense = sp.csr_matrix(x[:n_valid])
    for ref in (want, dense):
        npt.assert_array_equal(got.indptr, ref.indptr)
        npt.assert_array_equal(got.indices, ref.indices)
        npt.assert_array_equal(got.data.view(np.uint32), ref.data.view(np.uint32))
    with pytest.raises(ValueError, match="nonzeros"):
        trp.sharded_compact(xs, n_valid, 1024)


# ----- the downstream ops over device lists (tests/test_mesh_downstream.py) --------------


@pytest.fixture(scope="module")
def data():
    # not a multiple of 8: uneven shards
    return np.random.default_rng(7).normal(size=(203, 40)).astype(np.float32)


@pytest.fixture(scope="module")
def mesh8():
    import jax

    from infercnvpy_tpu.parallel.mesh import cell_mesh

    return cell_mesh(jax.devices()[:8])


@pytest.mark.parametrize(
    "kw", [dict(), dict(zero_center=True), dict(block_rows=64)], ids=["plain", "zero_center", "blocked"]
)
def test_truncated_svd_devices(data, mesh8, kw):
    from infercnvpy_tpu.ops.linalg import truncated_svd as jax_svd
    from infercnvpy_tpu_torch.ops.linalg import truncated_svd

    n_comps = 5 if kw else 10
    s1, c1, v1 = truncated_svd(data, n_comps, device="cpu", high_precision=True, **kw)
    s8, c8, v8 = truncated_svd(data, n_comps, device=["cpu"] * 8, high_precision=True, **kw)
    sj, cj, vj = jax_svd(data, n_comps, mesh=mesh8, **kw)
    for s, c, v in ((s1, c1, v1), (sj, cj, vj)):
        npt.assert_allclose(v8, v, rtol=1e-10)
        npt.assert_allclose(c8, c, rtol=1e-8, atol=1e-10)
        npt.assert_allclose(s8, s, rtol=1e-8, atol=1e-8)
    # float32, the default: the Gram partials summed in float64 on the host
    f1 = truncated_svd(data, n_comps, device="cpu", **kw)
    f8 = truncated_svd(data, n_comps, device=["cpu"] * 3, **kw)
    npt.assert_allclose(f8[2], f1[2], rtol=1e-5)


def test_exact_knn_devices(data, mesh8):
    from infercnvpy_tpu.ops.knn import exact_knn as jax_knn
    from infercnvpy_tpu_torch.ops.knn import exact_knn

    d1, i1 = exact_knn(data, 10, block=64, device="cpu")
    d8, i8 = exact_knn(data, 10, block=64, device=["cpu"] * 8)
    dj, ij = jax_knn(data, 10, block=64, mesh=mesh8)
    npt.assert_array_equal(i8, i1)
    npt.assert_array_equal(d8.view(np.uint32), d1.view(np.uint32))
    npt.assert_array_equal(i8, ij)
    npt.assert_allclose(d8, dj, rtol=1e-6, atol=1e-6)
    npt.assert_array_equal(i8[:, 0], np.arange(data.shape[0]))


def test_pearson_rows_devices(mesh8):
    from infercnvpy_tpu.ops.corr import pearson_rows as jax_pearson
    from infercnvpy_tpu_torch.ops.corr import pearson_rows

    X = np.random.default_rng(4).normal(size=(37, 25))
    got = pearson_rows(X, device=["cpu"] * 8)
    npt.assert_allclose(got, np.corrcoef(X, rowvar=True), rtol=1e-10, atol=1e-12)
    npt.assert_allclose(got, np.asarray(jax_pearson(X, mesh=mesh8)), rtol=1e-10, atol=1e-12)
    npt.assert_allclose(got, pearson_rows(X, device="cpu"), rtol=1e-12, atol=1e-14)


@pytest.fixture(scope="module")
def synthetic_pair():
    """The same synthetic AnnData through both packages' ``tl.infercnv`` (f64 input)."""
    import infercnvpy_tpu as cnv

    adata = tcnv.datasets.synthetic_cnv_dataset(n_cells=93, n_genes=300, seed=11)
    adata.X = sp.csr_matrix(adata.X).astype(np.float64)
    tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=CATS, device="cpu")
    ja = cnv.AnnData(X=adata.X.copy(), obs=adata.obs.copy(), var=adata.var.copy())
    cnv.tl.infercnv(ja, reference_key="cell_type", reference_cat=CATS)
    adata.obs["grp"] = ja.obs["grp"] = [f"g{i % 5}" for i in range(adata.shape[0])]
    return adata, ja


def test_cnv_score_devices(synthetic_pair, mesh8):
    from infercnvpy_tpu import tl as jtl

    adata, ja = synthetic_pair
    host = tcnv.tl.cnv_score(adata, groupby="grp", inplace=False, device="cpu")
    one = tcnv.tl.cnv_score(adata, groupby="grp", inplace=False, device=["cpu"])
    eight = tcnv.tl.cnv_score(adata, groupby="grp", inplace=False, device=["cpu"] * 8)
    jax_mesh = jtl.cnv_score(ja, groupby="grp", inplace=False, mesh=mesh8)
    assert set(host) == set(one) == set(eight) == set(jax_mesh)
    for g in host:
        npt.assert_allclose(eight[g], one[g], rtol=1e-12)
        npt.assert_allclose(eight[g], host[g], rtol=1e-5)
        npt.assert_allclose(eight[g], jax_mesh[g], rtol=1e-5)
    tcnv.tl.cnv_score(adata, groupby="grp", device=["cpu"] * 3)
    npt.assert_allclose(adata.obs["cnv_score"].to_numpy(), [eight[g] for g in adata.obs["grp"]], rtol=1e-12)


def test_cnv_score_devices_blocked():
    from infercnvpy_tpu_torch.tl._scores import _group_abs_mean_sharded

    rng = np.random.default_rng(3)
    X = rng.normal(size=(77, 12)).astype(np.float32)
    codes = rng.integers(0, 4, size=77)
    got = _group_abs_mean_sharded(sp.csr_matrix(X), codes, 4, [torch.device("cpu")] * 3, block_rows=16)
    want = np.array([np.abs(X[codes == g].astype(np.float64)).mean() for g in range(4)])
    npt.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("score", ["ithcna", "ithgex"])
def test_ith_scores_devices(mesh8, score):
    import infercnvpy_tpu as cnv

    adata = tcnv.datasets.synthetic_cnv_dataset(n_cells=70, n_genes=120, seed=9)
    tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=CATS, device="cpu")
    ja = cnv.AnnData(X=adata.X.copy(), obs=adata.obs.copy(), var=adata.var.copy())
    ja.obsm["X_cnv"] = adata.obsm["X_cnv"].copy()
    adata.obs["grp"] = ja.obs["grp"] = [f"g{i % 3}" for i in range(adata.shape[0])]
    one = getattr(tcnv.tl, score)(adata, "grp", inplace=False, device="cpu")
    eight = getattr(tcnv.tl, score)(adata, "grp", inplace=False, device=["cpu"] * 8)
    jax_mesh = getattr(cnv.tl, score)(ja, "grp", inplace=False, mesh=mesh8)
    assert set(one) == set(eight) == set(jax_mesh)
    for g in one:
        npt.assert_allclose(eight[g], one[g], rtol=1e-9, atol=1e-12)
        npt.assert_allclose(eight[g], jax_mesh[g], rtol=1e-9, atol=1e-12)


def test_pca_neighbors_devices(mesh8):
    import infercnvpy_tpu as cnv

    adata = tcnv.datasets.synthetic_cnv_dataset(n_cells=60, n_genes=300, seed=2)
    tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=CATS, device="cpu")
    a1, a8 = adata.copy(), adata.copy()
    tcnv.tl.pca(a1, device="cpu", high_precision=True)
    tcnv.pp.neighbors(a1, device="cpu")
    tcnv.tl.pca(a8, device=["cpu"] * 8, high_precision=True)
    tcnv.pp.neighbors(a8, device=["cpu"] * 8)
    ja = cnv.AnnData(X=adata.X.copy(), obs=adata.obs.copy(), var=adata.var.copy())
    ja.obsm["X_cnv"] = adata.obsm["X_cnv"].copy()
    cnv.tl.pca(ja, mesh=mesh8)
    cnv.pp.neighbors(ja, mesh=mesh8)
    for ref_pca, ref_dist in ((a1.obsm["X_cnv_pca"], a1.obsp["cnv_neighbors_distances"]),
                              (ja.obsm["X_cnv_pca"], ja.obsp["cnv_neighbors_distances"])):
        npt.assert_allclose(a8.obsm["X_cnv_pca"], ref_pca, rtol=1e-7, atol=1e-8)
        npt.assert_allclose(a8.obsp["cnv_neighbors_distances"].toarray(), ref_dist.toarray(), rtol=1e-5, atol=1e-6)


# ----- on the card -------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _launches():
    from infercnvpy_tpu_torch.ops.fused import fused_center_smooth_median_cuda
    from infercnvpy_tpu_torch.ops.gene import gene_project_cuda

    return {"fused_window": fused_center_smooth_median_cuda, "gene_project": gene_project_cuda}


@pytest.mark.cuda
@pytest.mark.parametrize("option", list(OPTIONS))
def test_cuda_two_shards_bit_identical_to_the_card(cuda, oligo, option):
    kw = OPTIONS[option]
    one = _run(oligo, "cuda:0", "csr", **kw)[0]
    for fn in _launches().values():
        fn.launches = 0
    two, info = _run(oligo, ["cuda:0", "cuda:0"], "csr", **kw)
    assert info == {"n_devices": 2, "sharded": True, "device_densify": False}
    _assert_bits(two, one)
    # batches are whole chunks: 16 cells a batch at chunks of 7 is 14
    batch = kw["batch_cells"] // kw["chunksize"] * kw["chunksize"] if "batch_cells" in kw else oligo.n_obs
    n_batches = -(-oligo.n_obs // batch)
    counts = {k: fn.launches for k, fn in _launches().items()}
    assert counts["fused_window"] == 2 * n_batches
    assert counts["gene_project"] == (2 * n_batches if kw.get("calculate_gene_values") else 0)


@pytest.mark.cuda
def test_cuda_downstream_two_shards(cuda, data):
    from infercnvpy_tpu_torch.ops.corr import pearson_rows
    from infercnvpy_tpu_torch.ops.knn import exact_knn
    from infercnvpy_tpu_torch.ops.linalg import truncated_svd

    two = ["cuda:0", "cuda:0"]
    d1, i1 = exact_knn(data, 10, block=64, device="cuda:0")
    d2, i2 = exact_knn(data, 10, block=64, device=two)
    npt.assert_array_equal(i2, i1)
    npt.assert_array_equal(d2.view(np.uint32), d1.view(np.uint32))
    npt.assert_allclose(truncated_svd(data, 10, device=two)[2], truncated_svd(data, 10, device="cuda:0")[2], rtol=1e-6)
    X = data.astype(np.float64)
    npt.assert_allclose(pearson_rows(X, device=two), pearson_rows(X, device="cuda:0"), rtol=1e-12, atol=1e-14)
