"""``tl.infercnv`` selects its genes through a column map, without copying the expression matrix.

The packers read the caller's matrix in place: the packed-column LUT of the
masked genes is spread onto the matrix's own columns, -1 for a gene left out
(unannotated, on an excluded chromosome) or used by no window.  Each path is
held bit for bit against the explicit subset, ``adata[:, keep]`` handed to
``_infercnv_compute`` without ``columns``: ``X_cnv``, ``chr_pos`` and the
gene values, on a var axis in scrambled order with unannotated genes, chrX,
chrY and a chromosome without the ``chr`` prefix.
"""

import json

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import infercnvpy_tpu_torch as tcnv  # noqa: E402
import infercnvpy_tpu_torch.core.anndata as anndata_mod  # noqa: E402
import infercnvpy_tpu_torch.tl._infercnv as drv  # noqa: E402
from infercnvpy_tpu_torch import native  # noqa: E402
from infercnvpy_tpu_torch.ops import sparse_ingest  # noqa: E402

REF_CAT = ["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"]
#: three batches of 32 cells, chunks of 16: the pipelined path
KW = dict(reference_key="cell_type", reference_cat=REF_CAT, window_size=20, step=5, chunksize=16, batch_cells=32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _adata(fmt=sp.csr_matrix, n_cells=96, n_genes=700, seed=11):
    """A dataset whose genes include 25 unannotated ones, chrX, chrY and 25 on chromosome ``"7"``, scrambled."""
    base = tcnv.datasets.synthetic_cnv_dataset(n_cells=n_cells, n_genes=n_genes, seed=seed, sparse_format=None)
    rng = np.random.default_rng(seed)
    var = base.var.copy()
    var["chromosome"] = var["chromosome"].astype(object)
    var[["start", "end"]] = var[["start", "end"]].astype(np.float64)
    picked = rng.choice(np.flatnonzero(~var["chromosome"].isin(["chrX", "chrY"]).to_numpy()), 50, replace=False)
    var.iloc[picked[:25], var.columns.get_loc("chromosome")] = None
    var.iloc[picked[:25], [var.columns.get_loc("start"), var.columns.get_loc("end")]] = np.nan
    var.iloc[picked[25:], var.columns.get_loc("chromosome")] = "7"
    perm = rng.permutation(n_genes)
    X = base.X[:, perm]
    adata = tcnv.AnnData(X=fmt(X) if fmt is not None else X, obs=base.obs.copy(), var=var.iloc[perm])
    assert {"chrX", "chrY", "7"} <= set(adata.var["chromosome"].dropna()) and adata.var["chromosome"].isnull().any()
    return adata


def _keep(adata) -> np.ndarray:
    chrom = adata.var["chromosome"]
    return (chrom.notnull() & ~chrom.isin(["chrX", "chrY"])).to_numpy()


def _explicit(adata, *, layer=None, device="cpu", checkpoint_dir=None, calculate_gene_values=False, **kw):
    """The subset copied as ``adata[:, keep]``, then ``_infercnv_compute`` without ``columns``."""
    keep = _keep(adata)
    ref = drv._get_reference(adata, KW["reference_key"], KW["reference_cat"], None, layer)[:, keep]
    sub = adata[:, keep]
    expr = sub.X if layer is None else sub.layers[layer]
    var = sub.var.loc[:, ["chromosome", "start", "end"]]
    chr_pos, res, per_gene = drv._infercnv_compute(
        expr.tocsr() if sp.issparse(expr) else expr, var, np.asarray(ref, dtype=np.float64), lfc_clip=3,
        window_size=KW["window_size"], step=KW["step"], dynamic_threshold=1.5, chunksize=KW["chunksize"],
        batch_cells=KW["batch_cells"], dtype=None, device=tcnv._util.pick_devices(device, "test"), progress=False,
        calculate_gene_values=calculate_gene_values, checkpoint_dir=checkpoint_dir, **kw,
    )
    if calculate_gene_values:
        per_gene = drv._reindex_genes(per_gene, adata.obs.index, var.index, adata.var_names)
    return chr_pos, res, per_gene


def _mapped(adata, *, device="cpu", **kw):
    return tcnv.tl.infercnv(adata, inplace=False, device=device, **KW, **kw)


def _same(got, want):
    (pos_g, res_g, gene_g), (pos_w, res_w, gene_w) = got, want
    assert pos_g == pos_w
    assert res_g.shape == res_w.shape and res_g.nnz > 0
    npt.assert_array_equal(res_g.indptr, res_w.indptr)
    npt.assert_array_equal(res_g.indices, res_w.indices)
    assert res_g.data.dtype == res_w.data.dtype
    npt.assert_array_equal(res_g.data.view(np.uint8), res_w.data.view(np.uint8))
    if gene_w is None:
        assert gene_g is None
    else:
        assert gene_g.shape == gene_w.shape and gene_g.dtype == gene_w.dtype
        npt.assert_array_equal(_bits(gene_g), _bits(gene_w))


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


PATHS = {
    "sparse_device_densify": ({}, {}),
    "sparse_host_pack": ({}, {"device_densify": False}),
    "dense": ({"fmt": None}, {}),
    "layer": ({}, {"layer": "counts"}),
    "two_shards": ({}, {"device": ["cpu", "cpu"]}),
    "gene_values": ({}, {"calculate_gene_values": True}),
    "bfloat16": ({}, {"transfer_dtype": "bfloat16"}),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_column_map_equals_the_explicit_subset(path):
    data_kw, run_kw = PATHS[path]
    adata = _adata(**data_kw)
    if "layer" in run_kw:
        adata.layers["counts"] = adata.X
        adata.X = sp.csr_matrix(adata.shape, dtype=np.float32)  # X is not read
    want = _explicit(adata, **run_kw)
    before = drv._LAST_RUN_INFO.copy()
    got = _mapped(adata, **run_kw)
    assert drv._LAST_RUN_INFO == before  # the same execution path
    _same(got, want)


def test_checkpoint_written_and_resumed_through_the_column_map(tmp_path, monkeypatch):
    adata = _adata()
    want = _explicit(adata, calculate_gene_values=True, checkpoint_dir=tmp_path / "explicit")
    got = _mapped(adata, calculate_gene_values=True, checkpoint_dir=tmp_path / "mapped")
    _same(got, want)
    # the fingerprint is the digest of the masked matrix, as the explicit subset's
    manifest = [json.loads((tmp_path / d / "manifest.json").read_text()) for d in ("explicit", "mapped")]
    assert manifest[0] == manifest[1]
    batches = sorted((tmp_path / "mapped").glob("batch_*.npz"))
    assert len(batches) == 3
    batches[1].unlink()
    computed = []
    real = drv.sharded_infercnv_fn

    def counting(*a, **k):
        fn = real(*a, **k)

        def run(*args):
            computed.append(1)
            return fn(*args)

        return run

    monkeypatch.setattr(drv, "sharded_infercnv_fn", counting)
    _same(_mapped(adata, calculate_gene_values=True, checkpoint_dir=tmp_path / "mapped"), want)
    assert len(computed) == 1
    # the explicit run's directory resumes through the column map too: every batch from disk
    computed.clear()
    _same(_mapped(adata, calculate_gene_values=True, checkpoint_dir=tmp_path / "explicit"), want)
    assert computed == []


def test_the_callers_matrix_is_read_in_place(monkeypatch):
    adata = _adata()
    X = adata.X
    arrays = {k: getattr(X, k).copy() for k in ("indptr", "indices", "data")}
    want = _explicit(adata)

    def refuse(*a, **k):  # pragma: no cover - would indicate a copy of the subset
        raise AssertionError("the gene subset was copied")

    monkeypatch.setattr(anndata_mod.AnnData, "__getitem__", refuse)
    monkeypatch.setattr(anndata_mod, "_subset_matrix", refuse)
    _same(_mapped(adata), want)
    tcnv.tl.infercnv(adata, device="cpu", **KW)
    assert adata.X is X
    for k, v in arrays.items():
        npt.assert_array_equal(getattr(X, k), v)


def test_upload_capacity_counts_the_kept_genes_only(monkeypatch):
    """With a small nnz bucket the capacity follows each batch's nonzeros: the kept genes' count gives the
    explicit subset's bytes, the whole rows' count would give more."""
    monkeypatch.setattr(sparse_ingest, "_NNZ_BUCKET", 16)
    adata = _adata()
    keep = _keep(adata)
    columns = np.flatnonzero(keep)
    ref = np.asarray(drv._get_reference(adata, "cell_type", REF_CAT, None, None)[:, keep], dtype=np.float64)
    var = adata.var.loc[keep, ["chromosome", "start", "end"]]
    kw = dict(lfc_clip=3, window_size=20, step=5, dynamic_threshold=1.5, chunksize=16, batch_cells=32, dtype=None,
              device=torch.device("cpu"))
    mapped, explicit = {}, {}
    calls = native.count_in_columns.calls
    _, got, _ = drv._infercnv_compute(adata.X, var, ref, columns=columns, stats=mapped, **kw)
    assert native.count_in_columns.calls == calls + 3  # one count a batch
    _, want, _ = drv._infercnv_compute(adata.X[:, columns], var, ref, stats=explicit, **kw)
    _same(("", got, None), ("", want, None))
    assert mapped["h2d_bytes"] == explicit["h2d_bytes"] > 0
    whole_rows = max(int(adata.X.indptr[min(s + 32, 96)] - adata.X.indptr[s]) for s in range(0, 96, 32))
    assert sparse_ingest.round_nnz_cap(whole_rows) > sparse_ingest.round_nnz_cap(
        max(adata.X[s : s + 32, columns].nnz for s in range(0, 96, 32)))


def test_columns_are_checked():
    adata = _adata(n_cells=32)
    keep = _keep(adata)
    var = adata.var.loc[keep, ["chromosome", "start", "end"]]
    ref = np.zeros((1, len(var)))
    kw = dict(lfc_clip=3, window_size=20, step=5, dynamic_threshold=1.5, chunksize=16, batch_cells=None,
              dtype=None, device=torch.device("cpu"))
    columns = np.flatnonzero(keep)
    for bad in (columns[::-1], columns[:-1], np.r_[columns[:-1], adata.shape[1]]):
        with pytest.raises(ValueError, match="increasing positions"):
            drv._infercnv_compute(adata.X, var, ref, columns=bad, **kw)
    with pytest.raises(ValueError, match="increasing positions"):  # without columns, var must be all of expr
        drv._infercnv_compute(adata.X, var, ref, **kw)


@pytest.mark.parametrize("n_cols", [1, 37, 5000])
def test_count_in_columns_equals_its_plain_version(n_cols):
    rng = np.random.default_rng(n_cols)
    indices = rng.integers(0, n_cols, size=20_000).astype(np.int32)
    keep = rng.random(n_cols) < 0.7
    assert native.count_in_columns(indices, keep) == np.count_nonzero(keep[indices])
    assert native.count_in_columns(indices[:0], keep) == 0
    for bad in (-1, n_cols):
        with pytest.raises(IndexError, match="outside"):
            native.count_in_columns(np.r_[indices, bad].astype(np.int32), keep)
