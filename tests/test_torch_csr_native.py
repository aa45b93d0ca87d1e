"""The host CSR assembly of ``tl.infercnv``: ``native.mask_to_csr`` and the call-wide arrays it fills.

``native.mask_to_csr`` turns the result pack's word masks and compacted
values into CSR rows, in place in the call's arrays.  It is held, in bytes
and dtypes, against the plain assembly it replaced
(``ops/result_pack.py::mask_vals_to_csr`` / ``sharded_mask_vals_to_csr``) and
the JAX package's ``mask_vals_to_csr``; ``tl.infercnv`` end to end against the
plain assembly of each batch joined by ``sp.vstack``.  Every comparison is
exact: the assembly copies values and computes column ids, with no arithmetic
on the values.
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import infercnvpy_tpu_torch as tcnv  # noqa: E402
import infercnvpy_tpu_torch.tl._infercnv as drv  # noqa: E402
from infercnvpy_tpu.ops import result_pack as jrp  # noqa: E402
from infercnvpy_tpu_torch import native  # noqa: E402
from infercnvpy_tpu_torch.ops import result_pack as trp  # noqa: E402
from infercnvpy_tpu_torch.parallel import shard_rows  # noqa: E402

REF_CAT = ["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _word_mask(bits: np.ndarray, junk: np.random.Generator | None = None) -> np.ndarray:
    """(rows, w) booleans -> (rows, ceil(w / 32)) uint32 words, the bits past ``w`` set at random by ``junk``."""
    rows, w = bits.shape
    nw = -(-w // 32)
    full = np.zeros((rows, nw * 32), dtype=bool)
    full[:, :w] = bits
    if junk is not None:
        full[:, w:] = junk.random((rows, nw * 32 - w)) < 0.5
    packed = np.packbits(full.reshape(rows, nw * 4, 8), axis=-1, bitorder="little").reshape(rows, nw * 4)
    return np.ascontiguousarray(packed).view(np.uint32)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _assert_same(got: tuple, want) -> None:
    """``(data, indices, indptr)`` equal to the CSR ``want`` in bytes and dtypes."""
    data, indices, indptr = got
    for mine, theirs in ((data, want.data), (indices, want.indices), (indptr, want.indptr)):
        assert mine.dtype == theirs.dtype
        npt.assert_array_equal(_bits(np.ascontiguousarray(mine)), _bits(np.ascontiguousarray(theirs)))


def _plain(rows: int, w: int, dtype, *assemblies) -> list:
    """The plain assemblies' results; with no rows, which they cannot take (``unpackbits``' reshape), scipy's
    empty CSR."""
    return [a() for a in assemblies] if rows else [sp.csr_matrix((0, w), dtype=dtype)]


def _rows_of(kind: str, rows: int, w: int, rng) -> np.ndarray:
    bits = rng.random((rows, w)) < 0.3
    if kind == "empty_and_full" and rows:
        bits[0] = False
        bits[-1] = True
        bits[rows // 2] = False
    return bits


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("offset", [False, True], ids=["at_0", "at_offset"])
@pytest.mark.parametrize(
    "w,rows,kind",
    [(1, 5, "random"), (31, 7, "random"), (32, 9, "empty_and_full"), (33, 9, "empty_and_full"), (64, 6, "random"),
     (1793, 40, "empty_and_full"), (70, 0, "random"), (70, 1, "random"), (70, 1, "empty_and_full"),
     (33, 4, "all_empty")],
)
def test_mask_to_csr_equals_the_plain_assembly(w, rows, kind, offset, dtype):
    """One shard: the arrays written equal ``mask_vals_to_csr``'s (the port's and the JAX package's), shifted by
    the row and value offsets into larger arrays; nothing outside the batch's slots is touched."""
    rng = np.random.default_rng(w * 100 + rows)
    bits = np.zeros((rows, w), dtype=bool) if kind == "all_empty" else _rows_of(kind, rows, w, rng)
    mask = _word_mask(bits, rng)
    nnz = int(bits.sum())
    vals = np.zeros(max(1024, nnz + 17), dtype=dtype)
    vals[:nnz] = rng.normal(size=nnz) + 0.5
    row0, v0 = (3, 11) if offset else (0, 0)
    indptr = np.full(row0 + rows + 4, -7, dtype=np.int64)
    indptr[row0] = v0
    cap = v0 + nnz + 5
    indices = np.full(cap, -3, dtype=np.int32)
    data = np.full(cap, 9.0, dtype=dtype)

    assert native.mask_to_csr([mask], [vals], [nnz], w, indptr, indices, data, row=row0) == nnz

    got = (data[v0 : v0 + nnz], indices[v0 : v0 + nnz], (indptr[row0 : row0 + rows + 1] - v0).astype(np.int32))
    for want in _plain(rows, w, dtype, lambda: trp.mask_vals_to_csr(mask, vals[:nnz], w),
                       lambda: jrp.mask_vals_to_csr(mask, vals[:nnz], w)):
        _assert_same(got, want)
    assert (indptr[:row0] == -7).all() and (indptr[row0 + rows + 1 :] == -7).all()
    assert (indices[:v0] == -3).all() and (indices[v0 + nnz :] == -3).all()
    assert (data[:v0] == 9.0).all() and (data[v0 + nnz :] == 9.0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize(
    "n_rows,n_valid,n_dev,empty",
    [(320, 300, 8, 0), (96, 96, 3, 0), (90, 55, 3, 1), (40, 0, 2, 2), (12, 1, 4, 3)],
    ids=["padding_tail_8", "no_padding_3", "shard_without_rows", "no_valid_row", "one_row_4"],
)
def test_mask_to_csr_equals_the_sharded_plain_assembly(n_rows, n_valid, n_dev, empty, dtype):
    """Shards' masks and value segments, each read where it lies: equal to ``sharded_mask_vals_to_csr`` over the
    concatenated masks and segments, with a shard of no valid rows and padding rows at the tail."""
    rng = np.random.default_rng(n_rows + n_dev)
    x = rng.normal(size=(n_rows, 70))
    x[rng.random(x.shape) < 0.7] = 0
    x[n_rows // 3 : n_rows // 3 + 5] = 0
    xs = [torch.from_numpy(x[a:b]).to(dtype) for a, b in shard_rows(n_rows, n_dev)]
    masks, nnz = trp.sharded_mask_nnz(xs, n_valid)
    cap = trp.round_result_cap(max(nnz))
    segments = [v.numpy() for v in trp.sharded_compact(xs, n_valid, cap)]
    words = [m.numpy().view(np.uint32) for m in masks]
    assert sum(m.shape[0] == 0 for m in words) == empty

    total = sum(nnz)
    indptr = np.zeros(n_valid + 3, dtype=np.int64)
    indptr[2] = 5
    indices = np.empty(total + 5, dtype=np.int32)
    data = np.empty(total + 5, dtype=segments[0].dtype)
    assert native.mask_to_csr(words, segments, nnz, 70, indptr, indices, data, row=2, threads=3) == total

    mask, vals = np.concatenate(words), np.concatenate(segments)
    got = (data[5:], indices[5:], (indptr[2:] - 5).astype(np.int32))
    for want in _plain(n_valid, 70, vals.dtype, lambda: trp.sharded_mask_vals_to_csr(mask, vals, nnz, 70),
                       lambda: jrp.sharded_mask_vals_to_csr(mask, vals, np.asarray(nnz), 70)):
        _assert_same(got, want)
        npt.assert_array_equal(want.toarray(), x[:n_valid].astype(vals.dtype))


def test_mask_to_csr_refuses_what_it_cannot_write():
    bits = np.ones((4, 40), dtype=bool)
    mask = _word_mask(bits)
    vals = np.ones(1024, dtype=np.float32)
    indptr = np.zeros(5, dtype=np.int64)
    indices = np.empty(160, dtype=np.int32)
    data = np.empty(160, dtype=np.float32)
    with pytest.raises(ValueError, match="do not count"):
        native.mask_to_csr([mask], [vals], [159], 40, indptr, indices, data)
    with pytest.raises(ValueError, match="pass the arrays"):
        native.mask_to_csr([mask], [vals], [160], 40, indptr, indices[:150], data[:150])
    with pytest.raises(ValueError, match="uint32"):
        native.mask_to_csr([mask.view(np.int32)], [vals], [160], 40, indptr, indices, data)
    with pytest.raises(ValueError, match="uint32"):
        native.mask_to_csr([mask], [vals], [160], 70, indptr, indices, data)  # 3 words a row, not 2
    with pytest.raises(ValueError, match="values must be"):
        native.mask_to_csr([mask], [vals.astype(np.float64)], [160], 40, indptr, indices, data)
    with pytest.raises(ValueError, match="past indptr"):
        native.mask_to_csr([mask], [vals], [160], 40, indptr, indices, data, row=1)
    with pytest.raises(ValueError, match="C-contiguous 1-D"):
        native.mask_to_csr([mask], [vals], [160], 40, indptr.astype(np.int32), indices, data)


@pytest.mark.parametrize("nnz,beside,expected", [(0, False, 1), (drv._CSR_GRAIN - 1, True, 1),
                                                  (3 * drv._CSR_GRAIN, True, 3),
                                                  (5 * drv._CSR_GRAIN, False, 5), (10**12, True, 4),
                                                  (10**12, False, 8)])
def test_csr_fill_threads_follow_the_values_up_to_torch_or_half_beside_the_packer(monkeypatch, nnz, beside,
                                                                                    expected):
    monkeypatch.setattr(torch, "get_num_threads", lambda: 8)
    assert drv._csr_fill_threads(nnz, beside) == expected
    monkeypatch.setattr(torch, "get_num_threads", lambda: 1)
    assert drv._csr_fill_threads(nnz, beside) == 1


# ----- the call-wide arrays ---------------------------------------------------------------------------------


def _part(rows: int, w: int, density: float, seed: int, dtype=np.float32) -> sp.csr_matrix:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, w)).astype(dtype)
    x[rng.random(x.shape) >= density] = 0
    return sp.csr_matrix(x)


def test_call_csr_regrows_counts_its_copies_and_trims_in_place():
    """Batches of rising density overflow the first estimate: the arrays grow, the copy is counted, and the
    result, trimmed to its values, equals ``sp.vstack`` of the parts in bytes and dtypes; each batch's slice,
    ``indptr`` from 0, equals the part."""
    parts = [_part(10, 50, d, i) for i, d in enumerate((0.05, 0.3, 0.9, 0.0))]
    out = drv._CallCsr(40, 50, np.float32)
    copied = []
    for p in parts:
        words = _word_mask(p.toarray() != 0)
        vals = np.zeros(max(1024, p.nnz), np.float32)
        vals[: p.nnz] = p.data
        row0 = out.rows
        n, c = out.put_packed([words], [vals], [p.nnz], threads=2)
        assert n == p.nnz
        copied.append(c)
        _assert_same(out.batch(row0, out.rows), p)
    assert copied[0] == 0 and sum(copied) > 0
    assert len(out.indices) > out.nnz
    mat = out.matrix()
    assert len(out.indices) == len(out.data) == mat.nnz
    _assert_same((mat.data, mat.indices, mat.indptr), sp.vstack(parts, format="csr"))


def test_call_csr_copies_a_batch_in_at_its_offset():
    """A batch's own CSR arrays (a resumed or densely fetched batch), copied in after a packed one and counted:
    data, indices and the rows' ends, offset by the values before them."""
    parts = [_part(6, 30, 0.4, 1), _part(5, 30, 0.6, 2)]
    out = drv._CallCsr(11, 30, np.float32)
    words = _word_mask(parts[0].toarray() != 0)
    vals = np.zeros(1024, np.float32)
    vals[: parts[0].nnz] = parts[0].data
    out.put_packed([words], [vals], [parts[0].nnz], threads=1)
    second = parts[1]
    assert out.put(second.data, second.indices, second.indptr) == second.nnz * 8 + 5 * second.indptr.itemsize
    _assert_same(out.batch(6, 11), second)
    mat = out.matrix()
    _assert_same((mat.data, mat.indices, mat.indptr), sp.vstack(parts, format="csr"))


# ----- tl.infercnv end to end against the plain assembly ----------------------------------------------------


class _PlainCsr:
    """The assembly before ``native.mask_to_csr``: each batch by ``ops.result_pack``'s numpy functions over the
    concatenated shards, the parts joined by ``sp.vstack``; a batch's checkpoint is its own part."""

    def __init__(self, n_rows, n_cols, dtype):
        self.shape = (n_rows, n_cols)
        self.parts = []
        self.rows = 0

    def _add(self, mat):
        self.parts.append(mat)
        self.rows += mat.shape[0]

    def put_packed(self, masks, vals, seg_nnz, threads):
        mask = np.concatenate(masks)
        if len(vals) == 1:
            mat = trp.mask_vals_to_csr(mask, vals[0][: seg_nnz[0]], self.shape[1])
        else:
            mat = trp.sharded_mask_vals_to_csr(mask, np.concatenate(vals), seg_nnz, self.shape[1])
        self._add(mat)
        return mat.nnz, 0

    def put(self, data, indices, indptr):
        self._add(sp.csr_matrix((data, indices, indptr), shape=(len(indptr) - 1, self.shape[1])))
        return 0

    def batch(self, lo, hi):
        part = self.parts[-1]
        return part.data, part.indices, part.indptr

    def matrix(self):
        return sp.vstack(self.parts, format="csr") if len(self.parts) > 1 else self.parts[0]


@pytest.fixture(scope="module")
def adata():
    from infercnvpy_tpu_torch.datasets import synthetic_cnv_dataset

    return synthetic_cnv_dataset(n_cells=70, n_genes=900, seed=2)


def _run(adata, **kw):
    # 214 windows: the bitmask and values ship fewer bytes than the dense rows, so the batches come packed
    _, res, gene = tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=REF_CAT, inplace=False,
                                    chunksize=8, batch_cells=16, window_size=21, step=2, **kw)
    return res, gene


def _batch_files(ckpt):
    out = {}
    for f in sorted(ckpt.glob("batch_*.npz")):
        with np.load(f) as z:
            out[f.name] = {k: z[k] for k in z.files}
    return out


@pytest.mark.parametrize(
    "kw",
    [{}, {"compress_results": False}, {"calculate_gene_values": True}, {"dtype": np.float64},
     {"device": ["cpu"] * 3}, {"device": ["cpu"] * 3, "calculate_gene_values": True}],
    ids=["packed", "dense_fetch", "gene_values", "f64", "shards", "shards_gene_values"],
)
@pytest.mark.parametrize("resume", [False, True], ids=["fresh", "resumed"])
def test_infercnv_equals_the_plain_assembly(adata, tmp_path, monkeypatch, kw, resume):
    """``X_cnv`` (and the gene layer) of five batches equal, in bytes and dtypes, what the plain assembly and
    ``sp.vstack`` give; so do the checkpoint's batch files, and a resume with batches lost."""
    kw = {"device": "cpu", **kw}
    calls = native.mask_to_csr.calls
    runs = {}
    for name in ("native", "plain"):
        ckpt = tmp_path / name
        with monkeypatch.context() as m:
            if name == "plain":
                m.setattr(drv, "_CallCsr", _PlainCsr)
            res, gene = _run(adata, checkpoint_dir=ckpt, **kw)
            if resume:
                files = sorted(ckpt.glob("batch_*.npz"))
                assert len(files) == 5
                for f in (files[0], files[3]):
                    f.unlink()
                res, gene = _run(adata, checkpoint_dir=ckpt, **kw)
        runs[name] = (res, gene, _batch_files(ckpt))
    # the native fill ran on the native side's computed batches (the plain side replaces it)
    assert (native.mask_to_csr.calls > calls) == (kw.get("compress_results") is not False)
    (res, gene, files), (want, want_gene, want_files) = runs["native"], runs["plain"]
    _assert_same((res.data, res.indices, res.indptr), want)
    assert res.shape == want.shape
    if kw.get("calculate_gene_values"):
        assert gene.dtype == want_gene.dtype
        npt.assert_array_equal(_bits(gene), _bits(want_gene))
    assert list(files) == list(want_files)
    for name, arrays in files.items():
        assert list(arrays) == list(want_files[name])
        for key, a in arrays.items():
            assert a.dtype == want_files[name][key].dtype, (name, key)
            npt.assert_array_equal(a.view(np.uint8), want_files[name][key].view(np.uint8))
