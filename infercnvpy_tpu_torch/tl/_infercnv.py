"""`tl.infercnv` — the CNV-inference entry point (counterpart of ``infercnvpy_tpu/tl/_infercnv.py``).

API and numerics contract follow the reference entry point
(reference: tl/_infercnv.py:18-161) on one device:

* one transform (``ops.infercnv_kernel.build_infercnv_fn``) processes a whole
  device batch of cells — on a CUDA device in f32 through the fused kernel;
* the reference's chunk-scoped noise std (:448-453) is reproduced exactly via
  a segmented reduction keyed on ``floor(cell_index / chunksize)``, and
  batches are whole multiples of ``chunksize``, so results do not depend on
  batching;
* sparse input ships its CSR arrays and densifies on the device
  (``device_densify``); the gated result comes back as a bitmask plus the
  surviving values (``compress_results``);
* ``calculate_gene_values=True`` adds the per-gene matrix
  (``ops.gene.gene_project``, on a CUDA device in f32 through the gene
  kernel), fetched the same way and scattered back to the var axis with NaN
  for genes no window covers;
* the host packers run in native code (``native/pack.cpp``), and with more
  than one batch to compute and no ``stats`` the batches are pipelined: a
  worker thread packs batch k+1 into pinned buffers and copies it on a copy
  stream while the device computes batch k and the main thread assembles
  batch k-1 (the JAX package's prefetch thread, ``tl/_infercnv.py:734-849``);
* ``checkpoint_dir`` streams finished batches to disk in the JAX package's
  layout and resumes from them.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from collections.abc import Sequence
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pandas as pd
import scipy.sparse as sp
import torch

from .._util import _ensure_array, info, pick_device, warn
from ..genome.plan import build_window_plan
from ..ops.gene import gene_projection_data
from ..ops.infercnv_kernel import _pack_lut, build_infercnv_fn, pack_columns, pack_csr, packed_width

__all__ = ["infercnv", "clear_transform_caches"]


def infercnv(
    adata,
    *,
    reference_key: str | None = None,
    reference_cat: None | str | Sequence[str] = None,
    reference: np.ndarray | None = None,
    lfc_clip: float = 3,
    window_size: int = 100,
    step: int = 10,
    dynamic_threshold: float | None = 1.5,
    exclude_chromosomes: Sequence[str] | None = ("chrX", "chrY"),
    chunksize: int = 5000,
    n_jobs: int | None = None,
    inplace: bool = True,
    layer: str | None = None,
    key_added: str = "cnv",
    calculate_gene_values: bool = False,
    batch_cells: int | None = None,
    dtype=None,
    device=None,
    device_densify: bool | None = None,
    checkpoint_dir=None,
    progress=None,
    transfer_dtype: str | None = None,
    compress_results: bool | None = None,
):
    """Infer Copy Number Variation (CNV) by averaging gene expression over genomic regions.

    Parameters mirror the reference (reference: tl/_infercnv.py:18-96) and
    ``infercnvpy_tpu.tl.infercnv``.  ``n_jobs`` is accepted for API
    compatibility and ignored.  Additional parameters:

    batch_cells
        Number of cells per device batch.  ``None`` picks a multiple of
        ``chunksize`` targeting about 1.5 GB of dense input.  Does not affect
        numerics.
    dtype
        Compute dtype.  ``None`` uses float64 when the input is float64 or
        integer (the reference's numpy promotion), else float32.
    device
        One torch device (or its name).  ``None`` means the CUDA device and
        raises when ``torch.cuda.is_available()`` is false: pass
        ``device="cpu"`` to run on the CPU.  On CUDA, float32 runs through
        the fused kernel; other dtypes and the CPU run the plain PyTorch
        pipeline.
    device_densify
        For sparse input, ship the CSR arrays and densify on the device
        instead of packing a dense block on the host.  ``None`` (default)
        enables it for sparse input; ``False`` forces the host packer.  Does
        not affect numerics.
    checkpoint_dir
        Stream each finished cell batch to this directory
        (``batch_<start>.npz``, written atomically) and resume an interrupted
        run with the same configuration: finished batches load from disk
        instead of being computed, and the result is bit-identical.  A
        ``manifest.json`` fingerprint of the data and parameters refuses a
        directory written by a different configuration.  The layout and the
        fingerprint are the JAX package's.
    progress
        ``None`` (default) logs a line per batch at verbosity >= 2; ``True``
        always prints to stderr; ``False`` disables; a callable receives a dict
        with ``cells_done / cells_total / elapsed_sec / cells_per_sec /
        eta_sec``.
    transfer_dtype
        Ship the expression values host→device in a narrower float dtype
        (``"bfloat16"`` / ``"bf16"``, ``"float16"``, or any numpy float
        dtype); the device upcasts them to the compute dtype before any
        arithmetic.  ``None`` (default) ships the compute dtype, bit-exact.
    compress_results
        Fetch each batch's result as a nonzero bitmask + compacted values
        instead of the dense matrix (bit-identical CSR).  ``None`` (default)
        enables it whenever the noise gate is on; ``False`` forces the dense
        fetch.

    With ``calculate_gene_values=True`` the per-gene values go to
    ``layers[f"gene_values_{key_added}"]`` (or are returned third with
    ``inplace=False``): cells × all var genes, NaN for genes without a
    position, on excluded chromosomes, or covered by no window.

    With ``INFERCNVPY_TPU_TRACE_DIR`` set, each call is traced
    (``profiling.maybe_trace``).  More than one device is not ported yet and
    raises ``NotImplementedError``.
    """
    del n_jobs
    # validation: messages are observable API surface (reference tl/_infercnv.py:95-105)
    if adata.shape[0] == 0:
        raise ValueError("adata contains no cells — nothing to infer CNV from.")
    if not adata.var_names.is_unique:
        raise ValueError("Ensure your var_names are unique!")
    if not {"chromosome", "start", "end"}.issubset(adata.var.columns):
        raise ValueError(
            "Genomic positions not found. There need to be `chromosome`, `start`, and `end` columns in `adata.var`. "
        )
    dev = pick_device(device, "tl.infercnv")

    # gene selection: drop unannotated genes (warn) and excluded chromosomes
    chrom = adata.var["chromosome"]
    n_unannotated = int(chrom.isnull().sum())
    if n_unannotated:
        warn(f"Skipped {n_unannotated} genes because they don't have a genomic position annotated. ")
    keep = chrom.notnull()
    if exclude_chromosomes is not None:
        keep &= ~chrom.isin(exclude_chromosomes)
    keep = keep.values

    reference = _get_reference(adata, reference_key, reference_cat, reference, layer)[:, keep]

    sub = adata[:, keep]
    expr = sub.X if layer is None else sub.layers[layer]
    if sp.issparse(expr):
        expr = expr.tocsr()
    var = sub.var.loc[:, ["chromosome", "start", "end"]]

    from ..profiling import maybe_trace

    with maybe_trace("infercnv"):
        chr_pos, res, per_gene = _infercnv_compute(
            expr,
            var,
            np.asarray(reference, dtype=np.float64),
            lfc_clip=lfc_clip,
            window_size=window_size,
            step=step,
            dynamic_threshold=dynamic_threshold,
            chunksize=chunksize,
            batch_cells=batch_cells,
            dtype=dtype,
            device=dev,
            device_densify=device_densify,
            progress=progress,
            compress_results=compress_results,
            calculate_gene_values=calculate_gene_values,
            checkpoint_dir=checkpoint_dir,
            transfer_dtype=transfer_dtype,
        )
    if calculate_gene_values:
        per_gene = _reindex_genes(per_gene, adata.obs.index, var.index, adata.var_names)

    if inplace:
        adata.obsm[f"X_{key_added}"] = res
        adata.uns[key_added] = {"chr_pos": chr_pos}
        if calculate_gene_values:
            adata.layers[f"gene_values_{key_added}"] = per_gene
        return None
    return chr_pos, res, per_gene


def clear_transform_caches() -> None:
    """Drop every memoized per-plan structure (counterpart of the JAX package's, ``tl/_infercnv.py:226-253``).

    The port caches across calls, all keyed by ``plan.cache_key``: the
    gene-coverage groups of each window plan (``ops.gene._gpd_cache``) and the
    kernels' per-plan index tables on each device
    (``ops.fused._device_tables``, ``ops.gene._device_tables``).  The next call
    rebuilds what it needs; use from long-lived services between unrelated
    workloads.
    """
    from ..ops import fused as _fused
    from ..ops import gene as _gene

    _gene._gpd_cache.clear()
    _gene._device_tables.clear()
    _fused._device_tables.clear()


def _reindex_genes(per_gene: np.ndarray, obs_names, masked_names, var_names, stats: dict | None = None) -> np.ndarray:
    """Masked-var-axis gene values -> all of ``var_names``, NaN for the genes left out.

    As the JAX package does it (``infercnvpy_tpu/tl/_infercnv.py:161-166``):
    through a pandas reindex.  ``stats`` receives ``gene_reindex_sec``.
    """
    t0 = time.perf_counter()
    df = pd.DataFrame(per_gene, index=obs_names, columns=masked_names)
    out = df.reindex(columns=var_names, fill_value=np.nan).values
    if stats is not None:
        stats["gene_reindex_sec"] = stats.get("gene_reindex_sec", 0.0) + (time.perf_counter() - t0)
    return out


def _pick_dtype(expr, dtype) -> torch.dtype:
    """Compute dtype: explicit, else float64 for float64/int input (numpy promotion), else float32."""
    if dtype is not None:
        if not isinstance(dtype, torch.dtype):
            dtype = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}.get(np.dtype(dtype))
        if dtype not in (torch.float32, torch.float64):
            raise ValueError("dtype must be float32 or float64")
        return dtype
    if expr.dtype.kind in "iu" or expr.dtype == np.float64:
        return torch.float64
    return torch.float32


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


_TORCH_FLOAT = {np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def _transfer_dtype(transfer_dtype) -> tuple[torch.dtype | None, str | None]:
    """``(torch dtype, name)`` of the host→device value dtype; ``(None, None)`` ships the compute dtype.

    The name is what the JAX package records and hashes (``str`` of its
    numpy dtype: ``"bfloat16"``, ``"float16"``, ...).
    """
    if transfer_dtype is None:
        return None, None
    if str(transfer_dtype) in ("bf16", "bfloat16"):
        return torch.bfloat16, "bfloat16"
    dt = np.dtype(transfer_dtype)
    if dt.kind != "f" or dt not in _TORCH_FLOAT:
        raise ValueError(f"transfer_dtype must be a float dtype, got {transfer_dtype!r}")
    return _TORCH_FLOAT[dt], str(dt)


# ---------------------------------------------------------------------------
# Checkpoint / resume (the JAX package's layout and fingerprint)
# ---------------------------------------------------------------------------

#: dense input up to this many bytes is hashed whole, as the JAX package does
_DENSE_EXACT_BYTES = 1 << 30
#: above it, rows are hashed in blocks of about this many bytes, in parallel
_HASH_BLOCK_BYTES = 1 << 26


def _hash_row_blocks(arr: np.ndarray) -> bytes:
    """sha256 digests of consecutive row blocks of ``arr``, concatenated in row order.

    The blocks depend only on the shape and ``_HASH_BLOCK_BYTES``, so the
    result is exact and independent of the thread count and of any BLAS;
    hashlib releases the GIL, so the blocks hash in parallel.
    """
    step = max(1, _HASH_BLOCK_BYTES // max(1, arr.shape[1] * arr.itemsize))

    def digest(lo: int) -> bytes:
        return hashlib.sha256(memoryview(np.ascontiguousarray(arr[lo : lo + step]))).digest()

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return b"".join(pool.map(digest, range(0, arr.shape[0], step)))


def _ckpt_fingerprint(
    expr, var, reference, n_cells, n_genes, window_size, step, lfc_clip, dynamic_threshold,
    chunksize, calculate_gene_values, batch_cells, cdtype, transfer_dtype=None,
) -> str:
    """Configuration hash guarding checkpoint reuse (any mismatch = new run).

    The same digest as ``infercnvpy_tpu.tl._infercnv._ckpt_fingerprint`` for
    sparse input (indptr, indices and data bytes, exact) and for dense input
    up to 1 GiB (its bytes, exact): ``cdtype`` enters as its numpy name
    (``"float32"``), ``transfer_dtype`` as its name (``"bfloat16"``).  Larger
    dense input is hashed exactly too, as sha256 digests of row blocks
    (:func:`_hash_row_blocks`), where the JAX package hashes an f32 BLAS
    projection whose bits can vary with the BLAS build and thread count; so
    above 1 GiB the two digests differ, on purpose.
    """
    h = hashlib.sha256()
    if isinstance(cdtype, torch.dtype):
        cdtype = _np_dtype(cdtype)
    for item in (
        n_cells, n_genes, window_size, step, float(lfc_clip),
        None if dynamic_threshold is None else float(dynamic_threshold),
        chunksize, bool(calculate_gene_values), batch_cells, str(np.dtype(cdtype)),
        None if transfer_dtype is None else str(transfer_dtype),
    ):
        h.update(repr(item).encode())
    if sp.issparse(expr):
        x = expr.tocsr()
        h.update(repr((str(x.dtype), int(x.nnz))).encode())
        h.update(memoryview(np.ascontiguousarray(x.indptr)))
        h.update(memoryview(np.ascontiguousarray(x.indices)))
        h.update(memoryview(np.ascontiguousarray(x.data)))
    else:
        e_arr = np.asarray(expr)
        h.update(repr(str(e_arr.dtype)).encode())
        if e_arr.nbytes <= _DENSE_EXACT_BYTES:
            h.update(memoryview(np.ascontiguousarray(e_arr)))
        else:
            h.update(_hash_row_blocks(e_arr))
    h.update(np.ascontiguousarray(np.asarray(reference, dtype=np.float64)).tobytes())
    h.update(",".join(var["chromosome"].astype(str)).encode())
    h.update(np.ascontiguousarray(var["start"].to_numpy(np.int64)).tobytes())
    return h.hexdigest()


def _open_checkpoint(checkpoint_dir, fingerprint: str, n_cells: int, batch_cells: int) -> Path:
    """Create the directory and its manifest, or check the manifest of an existing one."""
    ckpt = Path(checkpoint_dir)
    ckpt.mkdir(parents=True, exist_ok=True)
    manifest = ckpt / "manifest.json"
    if manifest.exists():
        if json.loads(manifest.read_text()).get("fingerprint") != fingerprint:
            raise ValueError(
                f"checkpoint_dir {str(ckpt)!r} holds results for a DIFFERENT configuration "
                "(data, reference, or parameters changed) — clear it or pick another directory."
            )
    else:
        tmp = manifest.with_suffix(".json.tmp")
        tmp.write_text(json.dumps({"fingerprint": fingerprint, "n_cells": n_cells, "batch_cells": batch_cells}))
        tmp.replace(manifest)
    return ckpt


def _batch_file(ckpt: Path, start: int) -> Path:
    return ckpt / f"batch_{start:010d}.npz"


def _save_batch(ckpt: Path, start: int, mat: sp.csr_matrix, gene: np.ndarray | None) -> None:
    """Write one finished batch atomically (temporary file, then rename)."""
    payload = {"data": mat.data, "indices": mat.indices, "indptr": mat.indptr,
               "shape": np.asarray(mat.shape, np.int64)}
    if gene is not None:
        payload["gene"] = gene
    tmp = ckpt / f"batch_{start:010d}.npz.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, _batch_file(ckpt, start))


# ---------------------------------------------------------------------------
# Host staging of the copies
# ---------------------------------------------------------------------------


def _np_view(t: torch.Tensor) -> np.ndarray:
    """numpy view of a host tensor (bfloat16 as its uint16 bit patterns)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class _Uploads:
    """Two slots of host buffers for the batches' transfer arrays, and their copies to the device.

    The buffers are allocated once per run, pinned on CUDA.  Before a slot is
    packed again, :meth:`host` waits for the slot's previous copy; the copy
    runs on a copy stream of its own, and :meth:`ready` makes the consuming
    stream wait for it and tells the caching allocator that the tensors are
    used there (``record_stream``), so their memory is not reused while the
    compute still reads them.  On the CPU the "copy" hands over the slot's
    tensors themselves.
    """

    def __init__(self, device: torch.device, specs: dict):
        self.device = device
        self.cuda = device.type == "cuda"
        self.tensors = [
            {k: torch.empty(shape, dtype=dt, pin_memory=self.cuda) for k, (shape, dt) in specs.items()}
            for _ in range(2)
        ]
        self.arrays = [{k: _np_view(t) for k, t in slot.items()} for slot in self.tensors]
        self.nbytes = sum(t.numel() * t.element_size() for t in self.tensors[0].values())
        self._copied = [None, None]
        self._stream = torch.cuda.Stream(device) if self.cuda else None

    def host(self, slot: int) -> dict:
        """numpy views of the slot's buffers, once the slot's previous copy has finished."""
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        return self.arrays[slot]

    def to_device(self, slot: int):
        """Start the slot's copy to the device; returns ``(tensors, event)``."""
        if not self.cuda:
            return dict(self.tensors[slot]), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            dev = {k: t.to(self.device, non_blocking=True) for k, t in self.tensors[slot].items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        self._copied[slot] = event
        return dev, event

    def ready(self, dev: dict, event) -> dict:
        """The copied tensors, usable on the calling thread's current stream."""
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in dev.values():
                t.record_stream(stream)
        return dev


class _Downloads:
    """Two slots of pinned host buffers for the results' device→host copies (CUDA only).

    Each buffer grows to the largest payload it has held and is then reused,
    so a run allocates pinned memory a few times, not once per batch.  A
    slot is refilled two batches after its last use, when that batch's host
    assembly (which waited for its copies) is done; what the assembly keeps
    is copied out of the buffer.  On the CPU the result tensors are their
    own host buffers.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._buffers: list[dict] = [{}, {}]

    def fetch(self, slot: int, name: str, t: torch.Tensor) -> torch.Tensor:
        """Start copying ``t`` into the slot's buffer ``name``; returns the host tensor."""
        if not self.cuda:
            return t
        n = t.numel()
        buf = self._buffers[slot].get(name)
        if buf is None or buf.numel() < n or buf.dtype != t.dtype:
            buf = self._buffers[slot][name] = torch.empty(n, dtype=t.dtype, pin_memory=True)
        host = buf[:n].view(t.shape)
        host.copy_(t, non_blocking=True)
        return host

    def record(self):
        """An event after the copies started so far (None on the CPU)."""
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event


_TORCH_INT = {np.dtype(np.uint16): torch.uint16, np.dtype(np.int32): torch.int32}


def _infercnv_compute(
    expr,
    var: pd.DataFrame,
    reference: np.ndarray,
    *,
    lfc_clip: float,
    window_size: int,
    step: int,
    dynamic_threshold: float | None,
    chunksize: int,
    batch_cells: int | None,
    dtype,
    device: torch.device,
    device_densify: bool | None = None,
    stats: dict | None = None,
    progress=False,
    compress_results=None,
    calculate_gene_values: bool = False,
    checkpoint_dir=None,
    transfer_dtype=None,
):
    """Run the full pipeline; returns ``(chr_pos, csr result, per-gene matrix or None)``.

    The per-gene matrix is (cells, masked genes), NaN for uncovered genes.

    ``stats`` (optional) — a dict that receives a per-stage breakdown:
    ``host_pack_sec``, ``h2d_sec``, ``h2d_bytes``, ``compute_sec``,
    ``d2h_sec``, ``d2h_bytes`` (the window matrix), ``csr_sec`` (with the
    checkpoint writes), ``compile_sec`` (building and loading the native
    packer and the CUDA kernels), ``mode``, ``result_pack`` and, when set,
    ``transfer_dtype``; with gene values also ``gene_d2h_bytes`` (inside
    ``d2h_sec``), ``gene_unpack_sec`` (bitmask to dense on the host) and
    ``gene_scatter_sec`` (to the masked var axis).  Collecting it runs the
    batches one after another and synchronises the device between stages,
    so the stages are exact and their total bounds the pipelined wall time.

    ``checkpoint_dir`` and ``transfer_dtype`` as in :func:`infercnv`.
    """
    if sp.issparse(expr):
        expr = expr.tocsr()  # batches are row ranges of the CSR arrays
    n_cells, n_genes = expr.shape
    if n_cells == 0:
        raise ValueError("adata contains no cells — nothing to infer CNV from.")
    plan = build_window_plan(var, window_size, step)
    if plan.n_windows == 0:
        raise ValueError("No usable chromosomes found (need `chr*` prefixed chromosome annotations).")

    cdtype = _pick_dtype(expr, dtype)
    np_cdtype = _np_dtype(cdtype)
    tdt, tdt_name = _transfer_dtype(transfer_dtype)
    num_chunks = max(1, -(-n_cells // chunksize))

    if batch_cells is None:
        # target ≈1.5 GB of dense input per batch, rounded to whole chunks
        target = max(1, int(1.5e9 / max(1, n_genes * 4)))
        batch_cells = max(chunksize, (target // chunksize) * chunksize)
    else:
        batch_cells = max(chunksize, (batch_cells // chunksize) * chunksize)
    batch_cells = min(batch_cells, ((n_cells + chunksize - 1) // chunksize) * chunksize)
    # every batch ships this many rows; the last one's padding rows take the
    # sentinel chunk id num_chunks
    rows_padded = batch_cells if n_cells > batch_cells else n_cells

    use_sparse = device_densify is not False and sp.issparse(expr)
    use_result_pack = compress_results is True or (compress_results is None and dynamic_threshold is not None)
    timing = stats is not None
    on_cuda = device.type == "cuda"

    ckpt = None
    if checkpoint_dir is not None:
        fp = _ckpt_fingerprint(
            expr, var, reference, n_cells, n_genes, window_size, step, lfc_clip, dynamic_threshold,
            chunksize, calculate_gene_values, batch_cells, cdtype, tdt_name,
        )
        ckpt = _open_checkpoint(checkpoint_dir, fp, n_cells, batch_cells)
    starts = list(range(0, n_cells, batch_cells))
    resumed = {s for s in starts if ckpt is not None and _batch_file(ckpt, s).exists()}
    compute_starts = [s for s in starts if s not in resumed]
    slot_of = {s: i % 2 for i, s in enumerate(compute_starts)}
    use_prefetch = not timing and len(compute_starts) > 1

    def _sync():
        if timing and on_cuda:
            torch.cuda.synchronize(device)

    def _tick():
        _sync()
        return time.perf_counter() if timing else 0.0

    def _tock(key, t0):
        if timing:
            _sync()
            stats[key] = stats.get(key, 0.0) + (time.perf_counter() - t0)

    if timing:
        stats["mode"] = "device_densify" if use_sparse else "host_pack"
        stats["result_pack"] = use_result_pack
        if tdt_name is not None:
            stats["transfer_dtype"] = tdt_name
        stats["compile_sec"] = 0.0
        if compute_starts:
            from .. import native

            t0 = time.perf_counter()
            native.library()
            if on_cuda and cdtype == torch.float32:
                from ..ops import _build

                _build.library()
            stats["compile_sec"] = time.perf_counter() - t0

    gpd = gene_projection_data(plan) if calculate_gene_values else None
    lut = _pack_lut(plan, n_genes)
    width = packed_width(plan)
    stage_dtype = tdt if tdt is not None else cdtype

    t_run0 = time.perf_counter()

    def _progress(done):
        if progress is False:
            return
        elapsed = time.perf_counter() - t_run0
        rate = done / max(elapsed, 1e-9)
        eta = (n_cells - done) / max(rate, 1e-9)
        if callable(progress):
            progress({
                "cells_done": done, "cells_total": n_cells, "elapsed_sec": elapsed,
                "cells_per_sec": rate, "eta_sec": eta,
            })
            return
        msg = f"infercnv: {done:,}/{n_cells:,} cells ({rate:,.0f} cells/s, ETA {eta:.0f}s)"
        if progress is True:
            import sys

            print(msg, file=sys.stderr, flush=True)
        else:
            info(msg)

    res_parts = []
    gene_parts = []

    def _load_batch(start):
        with np.load(_batch_file(ckpt, start)) as z:
            res_parts.append(sp.csr_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"])))
            if gpd is not None:
                gene_parts.append(z["gene"])

    if compute_starts:
        from .. import native
        from ..ops.result_pack import compact, mask_nnz, mask_vals_to_csr, round_result_cap
        from ..ops.sparse_ingest import coo_from_csr_batch, col_index_dtype, densify, round_nnz_cap

        # the transform is built only here: a run whose every batch resumes
        # from the checkpoint builds and launches nothing
        fn = build_infercnv_fn(
            plan,
            n_ref_rows=reference.shape[0],
            lfc_clip=lfc_clip,
            dynamic_threshold=dynamic_threshold,
            num_chunks=num_chunks,
            calculate_gene_values=calculate_gene_values,
            dtype=cdtype,
        )
        ref_dev = torch.from_numpy(pack_columns(np.asarray(reference, dtype=np_cdtype), plan, lut)).to(device)

        specs = {"chunk": ((rows_padded,), torch.int64)}
        if use_sparse:
            # one nnz capacity for all batches of this run (the per-batch
            # maximum, bucket-rounded), so every batch ships buffers of one size
            ptr = expr.indptr
            shared_cap = round_nnz_cap(max(int(ptr[min(s + batch_cells, n_cells)] - ptr[s]) for s in starts))
            specs["cols"] = ((shared_cap,), _TORCH_INT[np.dtype(col_index_dtype(width))])
            specs["vals"] = ((shared_cap,), stage_dtype)
            specs["counts"] = ((rows_padded,), torch.int32)
            # bfloat16 is written by the native remap itself; another transfer
            # dtype is converted from the compute dtype after the remap
            convert = stage_dtype not in (cdtype, torch.bfloat16)
            scratch = np.empty(shared_cap, np_cdtype) if convert else None
        else:
            specs["x"] = ((rows_padded, width), stage_dtype)
            convert = stage_dtype != cdtype
            scratch = np.empty((rows_padded, width), np_cdtype) if convert else None
        uploads = _Uploads(device, specs)
        downloads = _Downloads(device)
        chunk_base = np.arange(rows_padded, dtype=np.int64)

        def _prepare(start):
            """Host half of one batch: pack into its slot, start the copy to the device."""
            slot = slot_of[start]
            stop = min(start + batch_cells, n_cells)
            rows = stop - start
            t0 = _tick()
            host = uploads.host(slot)
            nnz = None
            if use_sparse:
                val_dtype = "bfloat16" if stage_dtype == torch.bfloat16 else np_cdtype
                vals = scratch if convert else host["vals"]
                _, _, _, nnz = coo_from_csr_batch(
                    expr, lut, width, shared_cap, val_dtype, rows=(start, stop),
                    out=(host["cols"], vals, host["counts"][:rows]),
                )
                host["counts"][rows:] = 0
                key = "vals"
            else:
                block = scratch if convert else host["x"]
                if sp.issparse(expr):
                    pack_csr(expr, plan, lut, dtype=np_cdtype, rows=(start, stop), out=block[:rows])
                else:
                    raw = _ensure_array(np.asarray(expr[start:stop]))
                    pack_columns(raw, plan, lut, dtype=np_cdtype, out=block[:rows])
                block[rows:] = 0
                key = "x"
            if convert:
                # round to the transfer dtype on the host (torch's
                # round-to-nearest-even); the device upcasts again
                uploads.tensors[slot][key].copy_(torch.from_numpy(scratch))
            chunk = host["chunk"]
            np.floor_divide(chunk_base + start, chunksize, out=chunk)
            chunk[rows:] = num_chunks
            _tock("host_pack_sec", t0)

            t0 = _tick()
            dev, event = uploads.to_device(slot)
            if timing:
                stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + uploads.nbytes
            _tock("h2d_sec", t0)
            return dev, event, rows, nnz

        # one capacity per matrix: the gene matrix's nnz must not size the window fetch
        pack_caps = {"x": 0, "gene": 0}

        def _try_pack(arr: torch.Tensor, cap_key: str, rows: int):
            """``("packed", mask, vals, nnz)`` on the device, or None when the
            dense fetch would ship no more bytes."""
            # the int(nnz) in mask_nnz waits for this batch's compute; the
            # worker thread packs the next batch meanwhile
            mask, nnz = mask_nnz(arr, rows)
            pack_caps[cap_key] = max(pack_caps[cap_key], round_result_cap(nnz))
            cap = pack_caps[cap_key]
            if mask.numel() * mask.element_size() + cap * arr.element_size() >= arr.numel() * arr.element_size():
                return None
            return ("packed", mask, compact(arr, rows, cap), nnz)

        def _payload(arr: torch.Tensor, cap_key: str, rows: int):
            return (_try_pack(arr, cap_key, rows) if use_result_pack else None) or ("dense", arr[:rows])

        def _compute(dev: dict, rows: int, nnz):
            t0 = _tick()
            if use_sparse:
                x_dev = densify(dev["cols"], dev["vals"], dev["counts"], nnz, width, cdtype)
            else:
                x_dev = dev["x"]
            x_res, gene_res = fn(x_dev, ref_dev, dev["chunk"])
            x_payload = _payload(x_res, "x", rows)
            g_payload = _payload(gene_res, "gene", rows) if gpd is not None else None
            _tock("compute_sec", t0)
            return x_payload, g_payload

        def _fetch(payload, slot: int, name: str, bytes_key: str):
            """Start the device→host copies of one payload; returns it with host tensors."""
            if payload[0] == "packed":
                _, mask, vals, nnz = payload
                host = ("packed", downloads.fetch(slot, f"{name}_mask", mask),
                        downloads.fetch(slot, f"{name}_vals", vals), nnz)
                n_bytes = mask.numel() * mask.element_size() + vals.numel() * vals.element_size()
            else:
                host = ("dense", downloads.fetch(slot, f"{name}_dense", payload[1]))
                n_bytes = payload[1].numel() * payload[1].element_size()
            if timing:
                stats[bytes_key] = stats.get(bytes_key, 0) + n_bytes
            return host

        def _unpack_csr(host, n_cols: int) -> sp.csr_matrix:
            if host[0] == "packed":
                _, mask, vals, nnz = host
                return mask_vals_to_csr(mask.numpy().view(np.uint32), vals.numpy()[:nnz], n_cols)
            dense = host[1].numpy()
            return sp.csr_matrix(native.dense_to_csr(dense), shape=dense.shape)

        def _materialize(pending):
            """Host half of one finished batch: wait for its copies, assemble, checkpoint."""
            x_host, g_host, event, start = pending
            if event is not None:
                event.synchronize()
            t0 = _tick()
            mat = _unpack_csr(x_host, plan.n_windows)
            res_parts.append(mat)
            _tock("csr_sec", t0)
            g_np = None
            if g_host is not None:
                t0 = _tick()
                # per-gene values are consumed (and checkpointed) dense, copied
                # out of the reused host buffer
                g_np = np.array(g_host[1].numpy()) if g_host[0] == "dense" else _unpack_csr(g_host, gpd.total).toarray()
                gene_parts.append(g_np)
                _tock("gene_unpack_sec", t0)
            if ckpt is not None:
                t0 = _tick()
                _save_batch(ckpt, start, mat, g_np)
                _tock("csr_sec", t0)

    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="infercnv-pack") if use_prefetch else None
    futures: dict = {}
    if use_prefetch:
        futures[compute_starts[0]] = pool.submit(_prepare, compute_starts[0])
    next_prefetch = 1
    try:
        pending = None
        done_cells = 0
        for start in starts:
            stop = min(start + batch_cells, n_cells)
            if start in resumed:
                # drain the pipeline first, so parts stay in cell order
                if pending is not None:
                    _materialize(pending)
                    pending = None
                _load_batch(start)
                done_cells += stop - start
                _progress(done_cells)
                continue
            if use_prefetch:
                dev, event, rows, nnz = futures.pop(start).result()
                if next_prefetch < len(compute_starts):
                    nxt = compute_starts[next_prefetch]
                    futures[nxt] = pool.submit(_prepare, nxt)
                    next_prefetch += 1
            else:
                dev, event, rows, nnz = _prepare(start)
            x_payload, g_payload = _compute(uploads.ready(dev, event), rows, nnz)
            del dev
            t0 = _tick()
            slot = slot_of[start]
            x_host = _fetch(x_payload, slot, "x", "d2h_bytes")
            g_host = _fetch(g_payload, slot, "gene", "gene_d2h_bytes") if g_payload is not None else None
            fetched = downloads.record()
            _tock("d2h_sec", t0)
            del x_payload, g_payload
            if pending is not None:
                _materialize(pending)
            pending = (x_host, g_host, fetched, start)
            done_cells += stop - start
            _progress(done_cells)
        if pending is not None:
            _materialize(pending)
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    res = sp.vstack(res_parts, format="csr") if len(res_parts) > 1 else res_parts[0]
    per_gene = None
    if gpd is not None:
        t0 = _tick()
        used = np.concatenate(gene_parts, axis=0) if len(gene_parts) > 1 else gene_parts[0]
        # device gene columns are in coverage-group order; scatter them to the
        # masked var axis (uncovered genes stay NaN, as in the reference's reindex)
        per_gene = np.full((n_cells, n_genes), np.nan, dtype=used.dtype)
        per_gene[:, plan.used_genes[gpd.covered_sorted]] = used
        _tock("gene_scatter_sec", t0)
    return plan.chr_pos, res, per_gene


def _get_reference(
    adata,
    reference_key: str | None,
    reference_cat,
    reference: np.ndarray | None,
    layer: str | None,
) -> np.ndarray:
    """Reference-baseline extraction (behavior matches reference tl/_infercnv.py:359-408)."""
    if layer is not None:
        X = adata.layers[layer]
    else:
        X = adata.X

    if reference is None:
        if reference_key is None or reference_cat is None:
            warn(
                "No reference given — falling back to the mean over ALL cells as the baseline; "
                "pass `reference` or `reference_key`+`reference_cat` for meaningful CNV calls."
            )
            reference = _mean0(X)
        else:
            labels = np.asarray(adata.obs[reference_key].values)
            cats = np.array([reference_cat] if isinstance(reference_cat, str) else list(reference_cat))
            # error text is observable API surface (reference tl/_infercnv.py:388-392)
            absent = cats[~np.isin(cats, labels)]
            if absent.size:
                raise ValueError(f"Categories {absent} do not occur in `adata.obs[{reference_key!r}]`.")
            reference = np.vstack([_mean0(X[labels == cat, :]) for cat in cats])

    reference = np.asarray(reference)
    if reference.ndim == 1:
        reference = reference[np.newaxis, :]
    if reference.shape[1] != adata.shape[1]:
        raise ValueError("The reference baseline has a different gene count than `adata`.")
    return reference


def _mean0(X) -> np.ndarray:
    """Column means as a 1-D float64 array for dense or sparse input."""
    if sp.issparse(X):
        return np.asarray(X.mean(axis=0)).ravel()
    return np.asarray(np.mean(np.asarray(X), axis=0)).ravel()
