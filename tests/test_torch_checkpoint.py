"""Checkpoint / resume of the port's ``tl.infercnv`` (mirrors ``tests/test_checkpoint.py``).

The layout (``manifest.json`` + one ``batch_<start>.npz`` per batch) and the
fingerprint are the JAX package's: for sparse input and dense input up to
1 GiB the port's digest equals ``infercnvpy_tpu.tl._infercnv._ckpt_fingerprint``,
so a directory one package wrote resumes in the other.  Above 1 GiB the port
hashes row blocks exactly where the JAX package hashes an f32 BLAS projection
(tested with the threshold lowered through the module constant).  Resumed
results are bit-identical (tolerance 0).
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import infercnvpy_tpu_torch as tcnv  # noqa: E402
import infercnvpy_tpu_torch.tl._infercnv as drv  # noqa: E402
from infercnvpy_tpu_torch.datasets import synthetic_cnv_dataset  # noqa: E402

REF_CAT = ["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(adata, **kw):
    chr_pos, res, gene = tcnv.tl.infercnv(
        adata, reference_key="cell_type", reference_cat=REF_CAT, inplace=False, chunksize=8, batch_cells=16,
        device="cpu", **kw,
    )
    return chr_pos, res, gene


def _same_csr(a, b):
    assert a.shape == b.shape
    npt.assert_array_equal(a.indptr, b.indptr)
    npt.assert_array_equal(a.indices, b.indices)
    npt.assert_array_equal(a.data.view(np.uint32), b.data.view(np.uint32))


@pytest.fixture
def adata():
    return synthetic_cnv_dataset(n_cells=48, n_genes=400, seed=3)


class _CountingBuild:
    """Wraps ``sharded_infercnv_fn`` so a test can count the batches computed."""

    def __init__(self, real):
        self.real = real
        self.batches = 0

    def __call__(self, *a, **k):
        fn = self.real(*a, **k)

        def counted(*args):
            self.batches += 1
            return fn(*args)

        return counted


def test_checkpoint_matches_plain_run(adata, tmp_path):
    _, plain, _ = _run(adata)
    _, ck, _ = _run(adata, checkpoint_dir=tmp_path / "ck")
    _same_csr(plain, ck)
    files = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert "manifest.json" in files
    assert sum(f.startswith("batch_") and f.endswith(".npz") for f in files) == 3  # 48/16 batches


@pytest.mark.parametrize("fmt", [None, sp.csr_matrix], ids=["dense", "csr"])
def test_resume_loads_without_compute(tmp_path, monkeypatch, fmt):
    adata = synthetic_cnv_dataset(n_cells=48, n_genes=400, seed=3, sparse_format=fmt)
    _, first, _ = _run(adata, checkpoint_dir=tmp_path / "ck")

    def boom(*a, **k):  # pragma: no cover - would indicate a failure
        raise AssertionError("compute path entered despite complete checkpoint")

    # with every batch on disk a resumed run builds no transform and packs nothing
    monkeypatch.setattr(drv, "sharded_infercnv_fn", boom)
    monkeypatch.setattr(drv, "pack_columns", boom)
    _, resumed, _ = _run(adata, checkpoint_dir=tmp_path / "ck")
    _same_csr(first, resumed)


@pytest.mark.parametrize("lost", [[2], [0, 2], [1]], ids=["last", "first_and_last", "middle"])
def test_resume_after_partial_run(adata, tmp_path, monkeypatch, lost):
    _, full, _ = _run(adata, checkpoint_dir=tmp_path / "ck")
    batches = sorted((tmp_path / "ck").glob("batch_*.npz"))
    for i in lost:
        batches[i].unlink()
    counting = _CountingBuild(drv.sharded_infercnv_fn)
    monkeypatch.setattr(drv, "sharded_infercnv_fn", counting)
    events = []
    _, resumed, _ = _run(adata, checkpoint_dir=tmp_path / "ck", progress=events.append)
    _same_csr(full, resumed)
    assert counting.batches == len(lost)
    assert [e["cells_done"] for e in events] == [16, 32, 48]
    assert len(sorted((tmp_path / "ck").glob("batch_*.npz"))) == 3


def test_fingerprint_guards_config_change(adata, tmp_path):
    _run(adata, checkpoint_dir=tmp_path / "ck")
    with pytest.raises(ValueError, match="DIFFERENT configuration"):
        _run(adata, checkpoint_dir=tmp_path / "ck", lfc_clip=2.5)
    with pytest.raises(ValueError, match="DIFFERENT configuration"):
        _run(adata, checkpoint_dir=tmp_path / "ck", transfer_dtype="bfloat16")


def test_fingerprint_guards_data_change(adata, tmp_path):
    _run(adata, checkpoint_dir=tmp_path / "ck")
    adata2 = synthetic_cnv_dataset(n_cells=48, n_genes=400, seed=4)
    with pytest.raises(ValueError, match="DIFFERENT configuration"):
        _run(adata2, checkpoint_dir=tmp_path / "ck")


def test_checkpoint_with_gene_values(adata, tmp_path):
    _, plain, gplain = _run(adata, calculate_gene_values=True)
    _, ck, gck = _run(adata, calculate_gene_values=True, checkpoint_dir=tmp_path / "ck")
    _same_csr(plain, ck)
    npt.assert_array_equal(gplain.view(np.uint32), gck.view(np.uint32))
    (sorted((tmp_path / "ck").glob("batch_*.npz"))[1]).unlink()
    _, r, gr = _run(adata, calculate_gene_values=True, checkpoint_dir=tmp_path / "ck")
    _same_csr(plain, r)
    npt.assert_array_equal(gplain.view(np.uint32), gr.view(np.uint32))


def test_checkpoint_sparse_input_and_bf16_transfer(tmp_path):
    adata = synthetic_cnv_dataset(n_cells=32, n_genes=300, seed=5, sparse_format=sp.csr_matrix)
    for kw in ({}, {"transfer_dtype": "bfloat16"}):
        _, plain, _ = _run(adata, **kw)
        d = tmp_path / f"ck{len(kw)}"
        _, ck, _ = _run(adata, checkpoint_dir=d, **kw)
        _same_csr(plain, ck)
        sorted(d.glob("batch_*.npz"))[0].unlink()
        _, again, _ = _run(adata, checkpoint_dir=d, **kw)
        _same_csr(plain, again)


@pytest.mark.parametrize("fmt", [None, sp.csr_matrix], ids=["dense", "csr"])
def test_resumes_a_directory_the_jax_package_wrote(tmp_path, monkeypatch, fmt):
    import infercnvpy_tpu as cnv

    adata = synthetic_cnv_dataset(n_cells=48, n_genes=400, seed=3, sparse_format=fmt)
    a_j = cnv.AnnData(X=adata.X.copy(), obs=adata.obs.copy(), var=adata.var.copy())
    _, want, _ = cnv.tl.infercnv(a_j, reference_key="cell_type", reference_cat=REF_CAT, inplace=False, chunksize=8,
                                 batch_cells=16, mesh=False, checkpoint_dir=tmp_path / "ck")

    def boom(*a, **k):  # pragma: no cover - would indicate a failure
        raise AssertionError("the JAX package's checkpoint was not resumed")

    monkeypatch.setattr(drv, "sharded_infercnv_fn", boom)
    _, got, _ = _run(adata, checkpoint_dir=tmp_path / "ck")
    _same_csr(got, want.tocsr())


def _fp_args(expr, **kw):
    args = dict(n_cells=expr.shape[0], n_genes=expr.shape[1], window_size=50, step=10, lfc_clip=3.0,
                dynamic_threshold=1.5, chunksize=16, calculate_gene_values=False, batch_cells=32, cdtype=np.float32)
    args.update(kw)
    return args


def _toy(n_cells=64, n_genes=600, seed=0):
    """tests/test_pipeline.py's toy input."""
    rng = np.random.default_rng(seed)
    rows = []
    for c in range(4):
        rows += [(f"chr{c + 1}", int(s)) for s in np.sort(rng.integers(1, 2**27, size=n_genes // 4))]
    var = pd.DataFrame(rows, columns=["chromosome", "start"])
    var["end"] = var["start"] + 1000
    expr = sp.random(n_cells, n_genes, density=0.08, format="csr", dtype=np.float32, random_state=seed)
    ref = np.asarray(expr[: n_cells // 4].mean(axis=0), dtype=np.float64)
    return expr, var, ref


@pytest.mark.parametrize("fmt", ["csr", "dense"])
@pytest.mark.parametrize("kw", [{}, {"transfer_dtype": "bfloat16"}, {"dynamic_threshold": None, "cdtype": np.float64}],
                         ids=["default", "bf16", "nogate_f64"])
def test_fingerprint_equals_jax(fmt, kw):
    from infercnvpy_tpu.tl._infercnv import _ckpt_fingerprint as jax_fp

    expr, var, ref = _toy()
    if fmt == "dense":
        expr = np.asarray(expr.todense())
    args = _fp_args(expr, **kw)
    assert drv._ckpt_fingerprint(expr, var, ref, **args) == jax_fp(expr, var, ref, **args)
    # _infercnv_compute hands the compute dtype over as a torch dtype
    torch_args = dict(args, cdtype=torch.float64 if args["cdtype"] == np.float64 else torch.float32)
    assert drv._ckpt_fingerprint(expr, var, ref, **torch_args) == jax_fp(expr, var, ref, **args)


def test_fingerprint_detects_transfer_dtype_and_row_permutation():
    expr, var, ref = _toy()
    args = _fp_args(expr)
    fp = drv._ckpt_fingerprint(expr, var, ref, **args)
    assert fp != drv._ckpt_fingerprint(expr, var, ref, transfer_dtype="bfloat16", **args)
    perm = np.random.default_rng(0).permutation(64)
    assert (perm[:32] != np.arange(32)).any()
    assert fp != drv._ckpt_fingerprint(expr[perm], var, ref, **args)
    assert fp == drv._ckpt_fingerprint(expr.copy(), var, ref, **args)
    dense = np.asarray(expr.todense())
    fp_d = drv._ckpt_fingerprint(dense, var, ref, **args)
    assert fp_d != drv._ckpt_fingerprint(dense[perm], var, ref, **args)
    swapped = dense.copy()
    swapped[[1, 2]] = swapped[[2, 1]]
    assert fp_d != drv._ckpt_fingerprint(swapped, var, ref, **args)
    assert drv._ckpt_fingerprint(sp.csr_matrix(swapped), var, ref, **args) != drv._ckpt_fingerprint(
        sp.csr_matrix(dense), var, ref, **args)


def test_large_dense_fingerprint_is_exact_and_deterministic(monkeypatch):
    """Above the 1 GiB threshold (lowered here) dense input hashes row blocks:
    a digest other than the exact whole-array one (which is the JAX
    package's), the same for any memory layout, and changed by any edit."""
    expr, var, ref = _toy(n_cells=200)
    dense = np.asarray(expr.todense())
    args = _fp_args(dense)
    whole = drv._ckpt_fingerprint(dense, var, ref, **args)
    monkeypatch.setattr(drv, "_DENSE_EXACT_BYTES", 1024)
    monkeypatch.setattr(drv, "_HASH_BLOCK_BYTES", 7 * dense.shape[1] * 4)  # 29 blocks of 7 rows
    fp = drv._ckpt_fingerprint(dense, var, ref, **args)
    assert fp != whole
    assert fp == drv._ckpt_fingerprint(dense.copy(), var, ref, **args)
    assert fp == drv._ckpt_fingerprint(np.asfortranarray(dense), var, ref, **args)
    edited = dense.copy()
    edited[199, 599] += 1e-3
    assert fp != drv._ckpt_fingerprint(edited, var, ref, **args)
    moved = dense.copy()
    c_nz, c_zero = np.flatnonzero(moved[5])[0], np.flatnonzero(moved[5] == 0)[0]
    moved[5, [c_nz, c_zero]] = moved[5, [c_zero, c_nz]]
    assert fp != drv._ckpt_fingerprint(moved, var, ref, **args)
    perm = np.arange(200)
    perm[[10, 150]] = perm[[150, 10]]
    assert fp != drv._ckpt_fingerprint(dense[perm], var, ref, **args)
