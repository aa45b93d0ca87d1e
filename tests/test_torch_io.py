"""The port's ``io`` against ``infercnvpy_tpu.io`` on the same inputs, and the port's public names.

Every case of ``tests/test_io.py`` runs through both packages and the outputs
are compared: frames with ``pd.testing.assert_frame_equal`` (dtypes
included), arrays exactly, warning texts as printed.  GTF → ``tl.infercnv``
is held at ROADMAP's whole-run bars: float64 at rtol 1e-9 / atol 1e-12,
float32 at rtol 1e-5 / atol 1e-5 with gate flips only within 1e-5 of a
chunk's threshold.  No test touches the network: Biomart's ``urlopen`` is
stubbed.
"""

import bz2
import gzip
import inspect
import lzma
import struct
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import infercnvpy_tpu as cnv  # noqa: E402
import infercnvpy_tpu.io._genepos as jgenepos  # noqa: E402
import infercnvpy_tpu.io._rdata as jrdata  # noqa: E402
import infercnvpy_tpu_torch as tcnv  # noqa: E402
import infercnvpy_tpu_torch.io._genepos as tgenepos  # noqa: E402
import infercnvpy_tpu_torch.io._rdata as trdata  # noqa: E402

CATS = ["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"]
FLIP_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(genes, ids=None, X=None):
    """The same AnnData contents in both packages."""
    X = np.ones((3, len(genes)), dtype=np.float32) if X is None else X
    var = pd.DataFrame(index=pd.Index(genes))
    if ids is not None:
        var["gene_ids"] = ids
    return tcnv.AnnData(X=X.copy(), var=var.copy()), cnv.AnnData(X=X.copy(), var=var.copy())


def _both(capsys, fn_t, fn_j):
    """Run the port's and the JAX package's call; returns both results and both stderr texts."""
    capsys.readouterr()
    got = fn_t()
    err_t = capsys.readouterr().err
    want = fn_j()
    err_j = capsys.readouterr().err
    return got, want, err_t, err_j


# ---------------------------------------------------------------------------
# GTF
# ---------------------------------------------------------------------------


@pytest.fixture(params=["plain", "gzip"])
def gtf_files(request, testdata, tmp_path):
    """``mini.gtf`` and ``mini_ensembl.gtf``, as they are or gzipped into ``tmp_path``."""
    files = {name: testdata / f"{name}.gtf" for name in ("mini", "mini_ensembl")}
    if request.param == "gzip":
        for name, path in list(files.items()):
            gz = tmp_path / f"{name}.gtf.gz"
            gz.write_bytes(gzip.compress(path.read_bytes()))
            files[name] = gz
    return files


@pytest.mark.parametrize("name", ["mini", "mini_ensembl"])
@pytest.mark.parametrize("features", [None, {"gene"}, {"exon"}], ids=["all", "gene", "exon"])
def test_read_gtf(gtf_files, name, features):
    got = tgenepos.read_gtf(gtf_files[name], features=features)
    want = jgenepos.read_gtf(gtf_files[name], features=features)
    pd.testing.assert_frame_equal(got, want)
    if name == "mini" and features == {"gene"}:
        assert len(got) == 6  # the exon line filtered out


GTF_CASES = {
    "by_name": (["GENEA", "GENEB", "GENEC", "GENED", "MISSING"], None, "mini", {}),
    "by_id": (
        ["a", "b", "c"],
        ["ENSG00000001", "ENSG00000004", "ENSG00000099"],
        "mini",
        {"adata_gene_id": "gene_ids", "gtf_gene_id": "gene_id"},
    ),
    "duplicates": (["DUPGENE", "GENEA"], None, "mini", {}),
    "chr_prefix": (["EGENE1", "EGENE2"], None, "mini_ensembl", {}),
}


@pytest.mark.parametrize("inplace", [True, False], ids=["inplace", "copy"])
@pytest.mark.parametrize("case", list(GTF_CASES))
def test_genomic_position_from_gtf(gtf_files, capsys, case, inplace):
    genes, ids, name, kw = GTF_CASES[case]
    a_t, a_j = _pair(genes, ids)
    got, want, err_t, err_j = _both(
        capsys,
        lambda: tcnv.io.genomic_position_from_gtf(gtf_files[name], a_t, inplace=inplace, **kw),
        lambda: cnv.io.genomic_position_from_gtf(gtf_files[name], a_j, inplace=inplace, **kw),
    )
    assert err_t == err_j
    if inplace:
        assert got is None and want is None
        got, want = a_t.var, a_j.var
    else:
        assert list(a_t.var.columns) == list(a_j.var.columns) == ([] if ids is None else ["gene_ids"])
    pd.testing.assert_frame_equal(got, want)
    assert got["chromosome"].dropna().str.startswith("chr").all()
    if case == "by_name":
        assert "1 genes of `adata` have no entry in the GTF file" in err_t
        assert got.loc["GENEA", "start"] == 5010000
    if case == "duplicates":
        assert "Dropped 1 genes" in err_t
        assert pd.isnull(got.loc["DUPGENE", "start"]) and not pd.isnull(got.loc["GENEA", "start"])
    if case == "by_id":
        assert int(got["start"].notnull().sum()) == 2  # version suffixes stripped


def _write_gtf(var: pd.DataFrame, path: Path, seed: int = 0) -> None:
    """A gzipped GENCODE-style GTF of ``var``'s genes: each a gene, a transcript and an exon line."""
    rng = np.random.default_rng(seed)
    lines = ["##description: made from a seeded var for the tests"]
    for i, (name, row) in enumerate(var.iterrows()):
        attrs = f'gene_id "ENSG{i:011d}.{rng.integers(1, 9)}"; gene_type "protein_coding"; gene_name "{name}";'
        for feature in ("gene", "transcript", "exon"):
            lines.append(f"{row.chromosome}\tTEST\t{feature}\t{row.start}\t{row.end}\t.\t+\t.\t{attrs}")
    path.write_bytes(gzip.compress(("\n".join(lines) + "\n").encode()))


def _assert_f32_close(got, want, chunk_thr):
    g, w = got.toarray(), want.toarray()
    flip = (g == 0) != (w == 0)
    v = np.abs(np.where(g != 0, g, w))
    near = np.abs(v - chunk_thr[:, None]) <= FLIP_TOL
    assert near[flip].all(), f"{int((flip & ~near).sum())} gate flips away from the threshold"
    npt.assert_allclose(g[~flip], w[~flip], rtol=1e-5, atol=1e-5)


def test_gtf_then_infercnv_mini(testdata):
    """``tests/test_io.py::test_gtf_then_infercnv``: four annotated genes straight into ``tl.infercnv``."""
    rng = np.random.default_rng(0)
    a_t, a_j = _pair(["GENEA", "GENEB", "GENEC", "GENED"], X=rng.random((8, 4)).astype(np.float32))
    tcnv.io.genomic_position_from_gtf(testdata / "mini.gtf", a_t)
    cnv.io.genomic_position_from_gtf(testdata / "mini.gtf", a_j)
    tcnv.tl.infercnv(a_t, window_size=2, step=1, dtype="float64", device="cpu")
    cnv.tl.infercnv(a_j, window_size=2, step=1, dtype="float64", mesh=False)
    assert a_t.uns["cnv"]["chr_pos"] == a_j.uns["cnv"]["chr_pos"]
    npt.assert_allclose(a_t.obsm["X_cnv"].toarray(), a_j.obsm["X_cnv"].toarray(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gtf_then_infercnv(tmp_path, capsys, dtype):
    """A GTF written from the synthetic genome annotates a bare ``var``; both packages' ``tl.infercnv`` agree on it."""
    data = tcnv.datasets.synthetic_cnv_dataset(n_cells=90, n_genes=600, seed=3)
    gtf = tmp_path / "genes.gtf.gz"
    _write_gtf(data.var, gtf)
    X = data.X
    bare = pd.DataFrame(index=data.var.index.copy())
    a_t = tcnv.AnnData(X=X.copy(), obs=data.obs.copy(), var=bare.copy())
    a_j = cnv.AnnData(X=X.copy(), obs=data.obs.copy(), var=bare.copy())
    _, _, err_t, err_j = _both(
        capsys,
        lambda: tcnv.io.genomic_position_from_gtf(gtf, a_t),
        lambda: cnv.io.genomic_position_from_gtf(gtf, a_j),
    )
    assert err_t == err_j == ""
    pd.testing.assert_frame_equal(a_t.var, a_j.var)
    npt.assert_array_equal(a_t.var[["start", "end"]].values, data.var[["start", "end"]].values)
    assert list(a_t.var["chromosome"]) == list(data.var["chromosome"])

    kw = dict(reference_key="cell_type", reference_cat=CATS, window_size=20, step=5, chunksize=40, dtype=dtype)
    tcnv.tl.infercnv(a_t, device="cpu", **kw)
    cnv.tl.infercnv(a_j, mesh=False, **kw)
    assert a_t.uns["cnv"]["chr_pos"] == a_j.uns["cnv"]["chr_pos"]
    got, want = a_t.obsm["X_cnv"], a_j.obsm["X_cnv"]
    assert got.shape == want.shape and got.shape[1] > 50
    if dtype == "float64":
        npt.assert_allclose(got.toarray(), want.toarray(), rtol=1e-9, atol=1e-12)
        return
    _, pre, _ = tcnv.tl.infercnv(a_t.copy(), device="cpu", inplace=False, **{**kw, "dynamic_threshold": None})
    pre = pre.toarray().astype(np.float64)
    thr = np.empty(pre.shape[0])
    for s in range(0, pre.shape[0], 40):
        thr[s : s + 40] = 1.5 * pre[s : s + 40].std()
    _assert_f32_close(got, want, thr)


# ---------------------------------------------------------------------------
# RData reader (hand-crafted XDR v2 streams, the writers of tests/test_io.py)
# ---------------------------------------------------------------------------


def _w_int(v):
    return struct.pack(">i", v)


def _w_flags(ptype, has_attr=False, has_tag=False):
    f = ptype
    if has_attr:
        f |= 0x200
    if has_tag:
        f |= 0x400
    return _w_int(f)


def _w_chars(s: str):
    b = s.encode()
    return _w_flags(9) + _w_int(len(b)) + b  # CHARSXP


def _w_sym(s: str):
    return _w_flags(1) + _w_chars(s)  # SYMSXP


def _w_strvec(values):
    out = _w_flags(16) + _w_int(len(values))
    for v in values:
        out += _w_chars(v)
    return out


def _w_realvec(values, attrs=b""):
    out = _w_flags(14, has_attr=bool(attrs)) + _w_int(len(values))
    for v in values:
        out += struct.pack(">d", float(v))
    return out + attrs


def _w_intvec(values, attrs=b"", ptype=13):
    out = _w_flags(ptype, has_attr=bool(attrs)) + _w_int(len(values))
    for v in values:
        out += _w_int(int(v))
    return out + attrs


def _w_nil():
    return _w_flags(254)


def _w_pairlist(items):
    """items: list of (name, payload_bytes)."""

    def rec(idx):
        if idx == len(items):
            return _w_nil()
        name, payload = items[idx]
        return _w_flags(2, has_tag=True) + _w_sym(name) + payload + rec(idx + 1)

    return rec(0)


NA_INT = -2147483648
COMPRESS = {"gzip": gzip.compress, "bz2": bz2.compress, "xz": lzma.compress, "none": lambda b: b}


def _rdata_bytes(bindings, compress=gzip.compress):
    body = b"RDX2\nX\n" + _w_int(2) + _w_int(0x030000) + _w_int(0x020300)
    body += _w_pairlist(bindings)
    return compress(body)


def _rds_bytes(payload, compress=gzip.compress):
    body = b"X\n" + _w_int(2) + _w_int(0x030000) + _w_int(0x020300)
    return compress(body + payload)


def _matrix(values, nrow, ncol, rownames, colnames):
    dimnames = _w_flags(19) + _w_int(2) + _w_strvec(rownames) + _w_strvec(colnames)
    attrs = _w_pairlist([("dim", _w_intvec([nrow, ncol])), ("dimnames", dimnames)])
    return _w_realvec(values, attrs=attrs)


def _data_frame(columns: dict, n_rows: int):
    attrs = _w_pairlist(
        [
            ("names", _w_strvec(list(columns))),
            ("row.names", _w_intvec([NA_INT, -n_rows])),  # compact row.names [NA, -n]
            ("class", _w_strvec(["data.frame"])),
        ]
    )
    return _w_flags(19, has_attr=True) + _w_int(len(columns)) + b"".join(columns.values()) + attrs


def _assert_same_r(got, want):
    assert type(got) is type(want)
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same_r(got[k], want[k])
    else:
        assert got.dtype == want.dtype
        npt.assert_array_equal(got, want)


RDATA_CASES = {
    "matrix": lambda: [("CNA_mtx_relat", _matrix([1, 2, 3, 4, 5, 6], 2, 3, ["r1", "r2"], ["c1", "c2", "c3"]))],
    "data_frame": lambda: [
        ("count_mtx_annot", _data_frame({"seqnames": _w_realvec([1, 1, 2]), "gene": _w_strvec(["a", "b", "c"])}, 3))
    ],
    "vectors_with_na": lambda: [
        ("ints", _w_intvec([4, NA_INT, -7])),
        ("flags", _w_intvec([1, 0, NA_INT], ptype=10)),
        ("reals", _w_realvec([3.5, -1.0])),
    ],
}


@pytest.mark.parametrize("compression", list(COMPRESS))
@pytest.mark.parametrize("case", list(RDATA_CASES))
def test_read_rdata(tmp_path, case, compression):
    path = tmp_path / "x.RData"
    path.write_bytes(_rdata_bytes(RDATA_CASES[case](), COMPRESS[compression]))
    got, want = trdata.read_rdata(path), jrdata.read_rdata(path)
    _assert_same_r(got, want)
    if case == "matrix":
        npt.assert_array_equal(got["CNA_mtx_relat"].values, [[1, 3, 5], [2, 4, 6]])
    if case == "vectors_with_na":
        assert list(got["flags"]) == [True, False, None]
        assert got["ints"][1] == np.iinfo(np.int64).min


RDS_CASES = {
    "vector": lambda: _w_realvec([3.5, -1.0]),
    "int_with_na": lambda: _w_intvec([1, NA_INT, 3]),
    "logical_with_na": lambda: _w_intvec([NA_INT, 1, 0], ptype=10),
    "matrix": lambda: _matrix([0.5, -0.5, 1.5, 2.5], 2, 2, ["g1", "g2"], ["cell_1", "cell_2"]),
}


@pytest.mark.parametrize("compression", ["gzip", "none"])
@pytest.mark.parametrize("case", list(RDS_CASES))
def test_read_rds(tmp_path, case, compression):
    path = tmp_path / "v.rds"
    path.write_bytes(_rds_bytes(RDS_CASES[case](), COMPRESS[compression]))
    _assert_same_r(trdata.read_rds(path), jrdata.read_rds(path))


def test_read_rdata_rejects_ascii(tmp_path):
    path = tmp_path / "a.RData"
    path.write_bytes(b"RDA2\nA\n" + b"0" * 16)
    with pytest.raises(ValueError) as got:
        trdata.read_rdata(path)
    with pytest.raises(ValueError) as want:
        jrdata.read_rdata(path)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# SCEVAN
# ---------------------------------------------------------------------------


@pytest.fixture(params=[False, True], ids=["no_subclones", "subclones"])
def scevan_dir(request, tmp_path):
    """A SCEVAN result directory: the CNA matrix (genes × cells), the annotation, the subclone matrix, the table."""
    cells = ["cell_1", "cell_2", "cell_4"]
    rng = np.random.default_rng(5)
    genes = [f"g{i}" for i in range(5)]
    (tmp_path / "s_CNAmtx.RData").write_bytes(
        _rdata_bytes([("CNA_mtx_relat", _matrix(rng.normal(size=15).round(3), 5, 3, genes, cells))])
    )
    anno = _data_frame({"seqnames": _w_realvec([1, 1, 2, 2, 5]), "gene_name": _w_strvec(genes)}, 5)
    (tmp_path / "s_count_mtx_annot.RData").write_bytes(_rdata_bytes([("count_mtx_annot", anno)]))
    if request.param:
        (tmp_path / "s_CNAmtxSubclones.RData").write_bytes(
            _rdata_bytes([("results.com", _matrix(rng.normal(size=10).round(3), 5, 2, genes, cells[1:]))])
        )
    table = tmp_path / "s_scevan_results.csv"
    pd.DataFrame(
        {"class": ["tumor", "normal", "tumor"], "confidentNormal": ["no", "yes", "no"], "subclone": [1.0, np.nan, 2.0]},
        index=cells,
    ).to_csv(table)
    return tmp_path, table


@pytest.mark.parametrize("inplace", [True, False], ids=["inplace", "copy"])
@pytest.mark.parametrize("with_table", [True, False], ids=["table", "no_table"])
@pytest.mark.parametrize("subset", [True, False], ids=["subset", "all_cells"])
@pytest.mark.parametrize("subclones", [True, False], ids=["use_subclones", "skip_subclones"])
def test_read_scevan(scevan_dir, capsys, subclones, subset, with_table, inplace):
    res_dir, table = scevan_dir
    obs = pd.DataFrame(index=["cell_1", "cell_2", "cell_3", "cell_4"])
    X = np.arange(8, dtype=np.float32).reshape(4, 2)
    a_t, a_j = tcnv.AnnData(X=X.copy(), obs=obs.copy()), cnv.AnnData(X=X.copy(), obs=obs.copy())
    kw = dict(subclones=subclones, subset=subset, inplace=inplace)
    tab = table if with_table else None
    got, want, err_t, err_j = _both(
        capsys,
        lambda: tcnv.io.read_scevan(a_t, res_dir, tab, **kw),
        lambda: cnv.io.read_scevan(a_j, res_dir, tab, **kw),
    )
    assert err_t == err_j
    assert ("No `scevan_res_table` specified" in err_t) is not with_table
    if inplace:
        assert got is None and want is None
        got, want = a_t, a_j
    else:
        assert a_t.shape == (4, 2) and "X_scevan" not in a_t.obsm
    assert got.shape == want.shape == ((3, 2) if subset else (4, 2))
    pd.testing.assert_frame_equal(got.obs, want.obs)
    npt.assert_array_equal(got.obsm["X_scevan"], want.obsm["X_scevan"])
    assert got.uns["scevan"] == want.uns["scevan"] == {"chr_pos": {"chr1": 0, "chr2": 2, "chr5": 4}}
    npt.assert_array_equal(got.X, want.X)


def test_read_scevan_rejects_incomplete_dir(tmp_path):
    a_t, a_j = tcnv.AnnData(X=np.ones((2, 2))), cnv.AnnData(X=np.ones((2, 2)))
    with pytest.raises(ValueError) as got:
        tcnv.io.read_scevan(a_t, tmp_path)
    with pytest.raises(ValueError) as want:
        cnv.io.read_scevan(a_j, tmp_path)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Biomart (``urlopen`` stubbed; the cache under each package's own datasetdir)
# ---------------------------------------------------------------------------

BIOMART_PAYLOAD = "ENSG1\t100\t200\t1\nENSG2\t300\t400\t2\nENSG3\t500\t900\tX\nENSG3\t510\t910\tX\nENSG4\t50\t60\t7\n"
BIOMART_ATTRS = ["ensembl_gene_id", "start_position", "end_position", "chromosome_name"]


@pytest.fixture()
def biomart(tmp_path, monkeypatch):
    """Both packages' ``datasetdir`` on their own ``tmp_path`` folder and ``urlopen`` answering from a payload."""
    from infercnvpy_tpu import settings as jsettings
    from infercnvpy_tpu_torch import settings as tsettings

    monkeypatch.setattr(tsettings, "datasetdir", tmp_path / "port")
    monkeypatch.setattr(jsettings, "datasetdir", tmp_path / "jax")
    calls = []

    class _Resp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return BIOMART_PAYLOAD.encode()

    def urlopen(request, timeout=None):
        calls.append((request.full_url, request.data, timeout))
        return _Resp()

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    return tmp_path, calls


def test_biomart_cache_roundtrip(biomart):
    """Repeats are served from ``settings.datasetdir/biomart`` of the port, without a request."""
    tmp_path, calls = biomart
    df1 = tgenepos.fetch_biomart_annotations("hsapiens", BIOMART_ATTRS)
    assert len(calls) == 1
    cached = list((tmp_path / "port" / "biomart").glob("*.parquet"))
    assert len(cached) == 1 and len(cached[0].stem) == 24
    df2 = tgenepos.fetch_biomart_annotations("hsapiens", BIOMART_ATTRS)
    assert len(calls) == 1  # the second call hit the cache
    pd.testing.assert_frame_equal(df1, df2)
    df3 = tgenepos.fetch_biomart_annotations("hsapiens", BIOMART_ATTRS, use_cache=False)
    assert len(calls) == 2
    pd.testing.assert_frame_equal(df1, df3)

    want = jgenepos.fetch_biomart_annotations("hsapiens", BIOMART_ATTRS)
    assert len(calls) == 3  # the JAX package's cache is its own
    pd.testing.assert_frame_equal(df1, want)
    assert [c[0] for c in calls] == [jgenepos._BIOMART_URL] * 3
    assert calls[0][1] == calls[2][1] and calls[0][2] == calls[2][2] == 60.0
    assert [p.name for p in (tmp_path / "jax" / "biomart").glob("*.parquet")] == [cached[0].name]


@pytest.mark.parametrize("inplace", [True, False], ids=["inplace", "copy"])
@pytest.mark.parametrize("by_column", [False, True], ids=["var_names", "var_column"])
def test_genomic_position_from_biomart(biomart, capsys, by_column, inplace):
    genes = ["ENSG2", "ENSG1", "ENSG3", "ENSG9"]
    ids = genes if by_column else None
    if by_column:
        a_t, a_j = _pair(["a", "b", "c", "d"], ids)
    else:
        a_t, a_j = _pair(genes)
    kw = dict(adata_gene_id="gene_ids" if by_column else None, inplace=inplace)
    got, want, err_t, err_j = _both(
        capsys,
        lambda: tcnv.io.genomic_position_from_biomart(a_t, **kw),
        lambda: cnv.io.genomic_position_from_biomart(a_j, **kw),
    )
    assert err_t == err_j
    assert "1 genes of `adata` have no Biomart annotation" in err_t and "Dropped 1 genes" in err_t
    if inplace:
        assert got is None and want is None
        got, want = a_t.var, a_j.var
    pd.testing.assert_frame_equal(got, want)
    assert got["chromosome"].iloc[:2].tolist() == ["chr2", "chr1"] and got["chromosome"].iloc[2:].isna().all()
    assert got["start"].iloc[:2].tolist() == [300, 100] and got["start"].iloc[2:].isna().all()


# ---------------------------------------------------------------------------
# Public names and isolation
# ---------------------------------------------------------------------------

PUBLIC = [
    ("io", "genomic_position_from_gtf"),
    ("io", "genomic_position_from_biomart"),
    ("io", "read_scevan"),
    ("io._genepos", "read_gtf"),
    ("io._genepos", "fetch_biomart_annotations"),
    ("io._rdata", "read_rdata"),
    ("io._rdata", "read_rds"),
    ("pl", "chromosome_heatmap"),
    ("pl", "chromosome_heatmap_summary"),
    ("pl", "embedding"),
    ("pl", "umap"),
    ("pl", "tsne"),
    ("tl", "copykat"),
    ("datasets", "maynard2020_3k"),
]


@pytest.mark.parametrize("module,name", PUBLIC, ids=[f"{m}.{n}" for m, n in PUBLIC])
def test_public_name_and_signature(module, name):
    import importlib

    got = getattr(importlib.import_module(f"infercnvpy_tpu_torch.{module}"), name)
    want = getattr(importlib.import_module(f"infercnvpy_tpu.{module}"), name)
    assert inspect.signature(got) == inspect.signature(want)


@pytest.mark.parametrize("module", ["io", "pl", "settings"])
def test_namespace_exports(module):
    import importlib

    got = importlib.import_module(f"infercnvpy_tpu_torch.{module}")
    want = importlib.import_module(f"infercnvpy_tpu.{module}")
    if module == "settings":
        assert got.figdir == want.figdir and got.autoshow is want.autoshow is True
        assert got.datasetdir != want.datasetdir
    else:
        assert got.__all__ == want.__all__
    assert getattr(tcnv, module) is got


def test_io_and_pl_import_without_jax():
    code = (
        "import sys, infercnvpy_tpu_torch.io, infercnvpy_tpu_torch.pl, infercnvpy_tpu_torch.tl._copykat; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'infercnvpy_tpu.')) "
        "or m == 'infercnvpy_tpu'); assert not bad, bad"
    )
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)
