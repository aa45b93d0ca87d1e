"""`tl.infercnv` — the CNV-inference entry point (counterpart of ``infercnvpy_tpu/tl/_infercnv.py``).

API and numerics contract follow the reference entry point
(reference: tl/_infercnv.py:18-161):

* one transform (``parallel.sharded_infercnv_fn``) processes a whole device
  batch of cells — on a CUDA device in f32 through the fused kernel; each
  batch is split into contiguous cell shards, one per device of the list
  (every visible GPU by default; a single device is one shard), each shard
  runs the front, and one chunk gate is taken over all of them, so any
  device count gives the bits of one device;
* the reference's chunk-scoped noise std (:448-453) is reproduced exactly via
  a segmented reduction keyed on ``floor(cell_index / chunksize)``, and
  batches are whole multiples of ``chunksize``, so results do not depend on
  batching;
* sparse input ships its CSR arrays and densifies on the device
  (``device_densify``); the gated result comes back as a bitmask plus the
  surviving values (``compress_results``), which native code turns into CSR
  rows in place in the call's result arrays (``native.mask_to_csr``);
* ``calculate_gene_values=True`` adds the per-gene matrix
  (``ops.gene.gene_project``, on a CUDA device in f32 through the gene
  kernel), fetched the same way and scattered back to the var axis with NaN
  for genes no window covers;
* the host packers run in native code (``native/pack.cpp``), and with more
  than one batch to compute and no ``stats`` :class:`_Pipeline` overlaps the
  batches: a worker thread packs batch k+1 into pinned buffers and copies it
  on a copy stream while the device computes batch k and the main thread
  assembles batch k-1 (the JAX package's prefetch thread, ``tl/_infercnv.py:734-849``);
* ``checkpoint_dir`` streams finished batches to disk in the JAX package's
  layout and resumes from them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import threading
import time
from collections.abc import Sequence
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pandas as pd
import scipy.sparse as sp
import torch

from .. import native, profiling
from .._util import _ensure_array, info, pick_devices, warn
from ..genome.plan import build_window_plan
from ..ops import _build, sparse_ingest
from ..ops.gene import gene_projection_data
from ..ops.infercnv_kernel import _pack_lut, pack_columns, pack_csr, packed_width
from ..ops.result_pack import _shard_local_valid, round_result_cap, sharded_compact, sharded_mask_nnz
from ..parallel.mesh import replicate, shard_rows
from ..parallel.sharded import sharded_infercnv_fn

__all__ = ["infercnv", "clear_transform_caches"]

#: execution details of the most recent `_infercnv_compute` call (test hook), the JAX
#: package's keys: {"n_devices": int, "sharded": bool, "device_densify": bool}
_LAST_RUN_INFO: dict = {}


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
        A torch device (or its name), or a list or tuple of them.  ``None``
        means every visible CUDA device, as the JAX package takes every
        device, and raises when ``torch.cuda.is_available()`` is false: pass
        ``device="cpu"`` to run on the CPU.  With more than one device each
        batch is split into contiguous cell shards, one per list entry (an
        entry may repeat: ``["cuda:0", "cuda:0"]`` runs two shards on one
        card); each shard runs the front on its device, and the chunk noise
        statistics are taken over all shards' rows, so the result is
        bit-identical to one device's.  On CUDA, float32 runs through the
        fused kernel; other dtypes and the CPU run the plain PyTorch
        pipeline.
    device_densify
        For sparse input on one device, ship the CSR arrays and densify on
        the device instead of packing a dense block on the host.  ``None``
        (default) enables it for sparse input on one device; ``False``
        forces the host packer.  On several devices the host packer runs,
        with a warning if ``True`` was asked for.  Does not affect numerics.
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
    (``profiling.maybe_trace``) into a fresh directory: the device's kernels
    and copies, and the call's stage spans on every thread, on one clock —
    the root ``infercnv``, ``infercnv.reference``, ``infercnv.subset``,
    ``infercnv.plan``, ``infercnv.setup`` / ``infercnv.slots``, per batch
    ``infercnv.pack`` and ``infercnv.h2d`` (on the packer thread when
    pipelined), ``infercnv.launch``, ``infercnv.d2h``, ``infercnv.csr`` and
    the rest that ``profiling`` lists, ``infercnv.wait`` wherever a thread
    blocks (its ``on``: ``"pack"``, ``"copies"``, ``"compute"`` or
    ``"memory"``), and the
    counters ``pinned_bytes``, ``h2d_bytes``, ``d2h_bytes``,
    ``subset_copy_bytes``, ``reference_nnz``, ``csr_nnz`` and
    ``csr_copied_bytes``.

    The reference means of CSR input (float32, float64 or integer values,
    int32 column ids) come from one native pass over the caller's arrays,
    bit-equal to scipy's mean of each category's rows; other input takes
    scipy or numpy.

    The genes are selected without a copy: the packers read the expression
    matrix in place through the kept genes' column positions.  Sparse input
    in another format than CSR is converted once (its bytes counted in
    ``subset_copy_bytes``, as is the masked copy the checkpoint's
    fingerprint hashes when genes are dropped).
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
    devices = pick_devices(device, "tl.infercnv")
    with profiling.maybe_trace("infercnv"), profiling.span(
        "infercnv", cells=adata.shape[0], genes=adata.shape[1], devices=len(devices)
    ):
        # gene selection: drop unannotated genes (warn) and excluded chromosomes
        chrom = adata.var["chromosome"]
        n_unannotated = int(chrom.isnull().sum())
        if n_unannotated:
            warn(f"Skipped {n_unannotated} genes because they don't have a genomic position annotated. ")
        keep = chrom.notnull()
        if exclude_chromosomes is not None:
            keep &= ~chrom.isin(exclude_chromosomes)
        keep = keep.values

        with profiling.span("infercnv.reference"):
            reference = _get_reference(adata, reference_key, reference_cat, reference, layer)[:, keep]

        # no gene subset is copied: the packers read the caller's matrix through
        # the kept genes' column positions
        n_kept = int(keep.sum())
        with profiling.span("infercnv.subset", genes_kept=n_kept, genes_dropped=len(keep) - n_kept):
            var = adata.var.loc[keep, ["chromosome", "start", "end"]]
            expr = _as_csr(adata.X if layer is None else adata.layers[layer])
            columns = np.flatnonzero(keep)

        chr_pos, res, per_gene = _infercnv_compute(
            expr,
            var,
            np.asarray(reference, dtype=np.float64),
            columns=columns,
            lfc_clip=lfc_clip,
            window_size=window_size,
            step=step,
            dynamic_threshold=dynamic_threshold,
            chunksize=chunksize,
            batch_cells=batch_cells,
            dtype=dtype,
            device=devices,
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
    gene-coverage groups of each window plan (``ops.gene._gpd_cache``), the
    kernels' per-plan index tables on each device
    (``ops.fused._device_tables``, ``ops.gene._device_tables``) and the
    sharded transforms (``parallel.sharded._BUILD_CACHE``).  The next call
    rebuilds what it needs; use from long-lived services between unrelated
    workloads.
    """
    from ..ops import fused as _fused
    from ..ops import gene as _gene
    from ..parallel import sharded as _sharded

    _gene._gpd_cache.clear()
    _gene._device_tables.clear()
    _fused._device_tables.clear()
    _sharded._BUILD_CACHE.clear()


class _Clock:
    """A call's stage spans and counters (``profiling``); with ``stats``, also its stage clock, which synchronizes
    the CUDA ``devices`` at both ends of a stage and adds its wall to ``stats[key]``, so a serialized run's stages
    are exact; a counter adds to ``stats[key]`` too."""

    def __init__(self, stats: dict | None, devices=()):
        self.stats = stats
        self.devices = devices if stats is not None else ()

    @contextlib.contextmanager
    def stage(self, name: str, key: str, parent=None, **attrs):
        """The span ``name`` (``profiling.span``), timed into ``stats[key]``."""
        with profiling.span(name, parent, **attrs):
            t0 = self._synchronize()
            yield
            if self.stats is not None:
                self.stats[key] = self.stats.get(key, 0.0) + (self._synchronize() - t0)

    def _synchronize(self) -> float:
        for d in self.devices:
            torch.cuda.synchronize(d)
        return time.perf_counter()

    def count(self, key: str, n: int) -> None:
        """Add ``n`` to the counter ``key`` of the open span, and with ``stats`` to ``stats[key]``."""
        profiling.count(key, n)
        if self.stats is not None:
            self.stats[key] = self.stats.get(key, 0) + n


def _reindex_genes(per_gene: np.ndarray, obs_names, masked_names, var_names, stats: dict | None = None) -> np.ndarray:
    """Masked-var-axis gene values -> all of ``var_names``, NaN for the genes left out.

    As the JAX package does it (``infercnvpy_tpu/tl/_infercnv.py:161-166``):
    through a pandas reindex.  ``stats`` receives ``gene_reindex_sec``.
    """
    with _Clock(stats).stage("infercnv.gene_reindex", "gene_reindex_sec"):
        df = pd.DataFrame(per_gene, index=obs_names, columns=masked_names)
        return df.reindex(columns=var_names, fill_value=np.nan).values


def _as_csr(expr):
    """``expr``, sparse input in CSR form: a CSR matrix is itself, another format is converted.

    A conversion's bytes go to the counter ``subset_copy_bytes``.
    """
    if not sp.issparse(expr) or expr.format == "csr":
        return expr
    expr = expr.tocsr()
    profiling.count("subset_copy_bytes", expr.data.nbytes + expr.indices.nbytes + expr.indptr.nbytes)
    return expr


def _masked_copy(expr, columns: np.ndarray):
    """The columns ``columns`` of ``expr`` as a new matrix, its bytes counted in ``subset_copy_bytes``."""
    if sp.issparse(expr):
        out = expr[:, columns]
        nbytes = out.data.nbytes + out.indices.nbytes + out.indptr.nbytes
    else:
        out = np.asarray(expr)[:, columns]
        nbytes = out.nbytes
    profiling.count("subset_copy_bytes", nbytes)
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


def _save_batch(ckpt: Path, start: int, csr: tuple, shape: tuple, gene: np.ndarray | None) -> None:
    """Write one finished batch, its CSR ``(data, indices, indptr)``, atomically (temporary file, then rename)."""
    data, indices, indptr = csr
    payload = {"data": data, "indices": indices, "indptr": indptr, "shape": np.asarray(shape, np.int64)}
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
    """Two slots of host buffers for the batches' transfer arrays, and their copies to the devices.

    The buffers are allocated once per run, pinned on CUDA.  Before a slot is
    packed again, :meth:`host` waits for the slot's previous copies; the
    copies run on a copy stream of each device's own, and :meth:`ready` makes
    the consuming stream wait for them and tells the caching allocator that
    the tensors are used there (``record_stream``), so their memory is not
    reused while the compute still reads them.  With several cell shards
    each shard's device receives its contiguous rows (``shards``, in device
    order) of every buffer; with one, the whole buffers.  On the CPU the
    "copy" hands over the slot's tensors (or their row slices) themselves.
    """

    def __init__(self, devices: list, shards: list, specs: dict):
        self.devices = devices
        self.shards = shards
        self.cuda = devices[0].type == "cuda"
        self.tensors = [
            {k: torch.empty(shape, dtype=dt, pin_memory=self.cuda) for k, (shape, dt) in specs.items()}
            for _ in range(2)
        ]
        self.arrays = [{k: _np_view(t) for k, t in slot.items()} for slot in self.tensors]
        self.nbytes = sum(t.numel() * t.element_size() for t in self.tensors[0].values())
        if self.cuda:
            profiling.count("pinned_bytes", 2 * self.nbytes)
        self._copied = [[], []]
        self._streams = {str(d): torch.cuda.Stream(d) for d in devices} if self.cuda else {}

    def host(self, slot: int) -> dict:
        """numpy views of the slot's buffers, once the slot's previous copies have finished."""
        if self._copied[slot]:
            with profiling.span("infercnv.wait", on="copies"):
                for event in self._copied[slot]:
                    event.synchronize()
        return self.arrays[slot]

    def to_device(self, slot: int) -> list:
        """Start the slot's copies to the devices; returns ``(tensors, event)`` for each shard."""
        whole = len(self.shards) == 1
        out = []
        for device, (lo, hi) in zip(self.devices, self.shards):
            part = {k: t if whole else t[lo:hi] for k, t in self.tensors[slot].items()}
            if not self.cuda:
                out.append((part, None))
                continue
            stream = self._streams[str(device)]
            with torch.cuda.device(device), torch.cuda.stream(stream):
                dev = {k: t.to(device, non_blocking=True) for k, t in part.items()}
                event = torch.cuda.Event()
                event.record(stream)
            out.append((dev, event))
        self._copied[slot] = [event for _, event in out if event is not None]
        return out

    def ready(self, dev: dict, event) -> dict:
        """The copied tensors, usable on their device's current stream."""
        if event is not None:
            stream = torch.cuda.current_stream(next(iter(dev.values())).device)
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

    def __init__(self, devices: list):
        self.cuda = devices[0].type == "cuda"
        self.devices = list({str(d): d for d in devices}.values())
        self._buffers: list[dict] = [{}, {}]

    def fetch(self, slot: int, name: str, t: torch.Tensor) -> torch.Tensor:
        """Start copying ``t`` into the slot's buffer ``name``; returns the host tensor."""
        if not self.cuda:
            return t
        n = t.numel()
        buf = self._buffers[slot].get(name)
        if buf is None or buf.numel() < n or buf.dtype != t.dtype:
            buf = self._buffers[slot][name] = torch.empty(n, dtype=t.dtype, pin_memory=True)
            profiling.count("pinned_bytes", n * t.element_size())
        host = buf[:n].view(t.shape)
        host.copy_(t, non_blocking=True)
        return host

    def record(self) -> list:
        """An event on each device after the copies started so far (none on the CPU)."""
        if not self.cuda:
            return []
        events = []
        for device in self.devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            events.append(event)
        return events


class _CallCsr:
    """A call's CSR result in one ``indptr`` / ``indices`` / ``data`` each, filled batch by batch in row order.

    Each batch writes its rows at its row offset and its values after the
    previous batch's: a packed result straight from the download buffers
    (``native.mask_to_csr``), any other batch's CSR arrays copied in.
    ``indices`` and ``data`` are sized from the values seen so far, spread
    over the call's rows with room to spare (pages never written cost no
    memory), and grow by at least half when a batch would pass them;
    :meth:`matrix` trims them in place.  The fill methods return the bytes
    they copied to join a batch or to regrow (``csr_copied_bytes``).
    """

    #: room over the estimated total
    SLACK = 1.25

    def __init__(self, n_rows: int, n_cols: int, dtype):
        self.shape = (n_rows, n_cols)
        self.indptr = np.zeros(n_rows + 1, dtype=np.int64)
        self.indices = np.empty(0, dtype=np.int32)
        self.data = np.empty(0, dtype=dtype)
        self.rows = 0  # rows filled

    @property
    def nnz(self) -> int:
        return int(self.indptr[self.rows])

    def _reserve(self, rows: int, nnz: int) -> int:
        """Room for ``rows`` more rows holding ``nnz`` values; returns the bytes copied to regrow."""
        need = self.nnz + nnz
        cap = len(self.indices)
        if need <= cap:
            return 0
        estimate = self.SLACK * need / (self.rows + rows) * self.shape[0]
        new = max(need, min(int(estimate), self.shape[0] * self.shape[1]), cap + cap // 2)
        filled = self.nnz
        indices = np.empty(new, dtype=np.int32)
        data = np.empty(new, dtype=self.data.dtype)
        indices[:filled] = self.indices[:filled]
        data[:filled] = self.data[:filled]
        self.indices, self.data = indices, data
        return filled * (indices.itemsize + data.itemsize)

    def put_packed(self, masks: list, vals: list, seg_nnz, threads: int) -> tuple[int, int]:
        """A packed batch (the shards' word masks and value segments); returns ``(values written, bytes copied)``."""
        rows = sum(m.shape[0] for m in masks)
        copied = self._reserve(rows, int(sum(seg_nnz)))
        n = native.mask_to_csr(masks, vals, seg_nnz, self.shape[1], self.indptr, self.indices, self.data,
                               row=self.rows, threads=threads)
        self.rows += rows
        return n, copied

    def put(self, data: np.ndarray, indices: np.ndarray, indptr: np.ndarray) -> int:
        """A batch's own CSR arrays (``indptr`` from 0), copied in; returns the bytes copied."""
        rows, nnz = len(indptr) - 1, int(indptr[-1])
        copied = self._reserve(rows, nnz)
        lo = self.nnz
        self.indices[lo : lo + nnz] = indices[:nnz]
        self.data[lo : lo + nnz] = data[:nnz]
        ends = self.indptr[self.rows + 1 : self.rows + rows + 1]
        ends[:] = indptr[1:]
        ends += lo
        self.rows += rows
        return copied + nnz * (indices.itemsize + data.itemsize) + rows * indptr.itemsize

    def batch(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Rows ``lo:hi`` as a CSR of their own, ``indptr`` from 0: a batch's exact arrays, for its checkpoint."""
        v0, v1 = int(self.indptr[lo]), int(self.indptr[hi])
        return self.data[v0:v1], *_index_dtypes(self.indices[v0:v1], self.indptr[lo : hi + 1] - v0)

    def matrix(self) -> sp.csr_matrix:
        """The filled rows as the call's result, ``indices`` and ``data`` trimmed in place to the values."""
        nnz = self.nnz
        # the trim shrinks each allocation (realloc) without a copy; nothing else refers to the arrays
        self.indices.resize(nnz, refcheck=False)
        self.data.resize(nnz, refcheck=False)
        indices, indptr = _index_dtypes(self.indices, self.indptr)
        return sp.csr_matrix((self.data, indices, indptr), shape=self.shape)


#: values a thread of the native CSR fill (``native.mask_to_csr``) takes on before another joins
_CSR_GRAIN = 1 << 15


def _csr_fill_threads(nnz: int, beside_packer: bool) -> int:
    """Threads for the native CSR fill of ``nnz`` values: one a :data:`_CSR_GRAIN` values, up to torch's count.

    While the packer thread's OpenMP team, of torch's count, packs a next
    batch beside the fill (``beside_packer``), at most half of it: two whole
    teams would oversubscribe the host.
    """
    cap = max(1, torch.get_num_threads())
    if beside_packer:
        cap = max(1, cap // 2)
    return max(1, min(cap, int(nnz) // _CSR_GRAIN))


def _index_dtypes(indices: np.ndarray, indptr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(indices, indptr)`` in one index dtype, as scipy needs: int32 while the values fit it, else int64."""
    if int(indptr[-1]) < 2**31 - 1:
        return indices, indptr.astype(np.int32)
    return indices.astype(np.int64), indptr  # pragma: no cover - more than 2^31 values


_TORCH_INT = {np.dtype(np.uint16): torch.uint16, np.dtype(np.int32): torch.int32}


@dataclasses.dataclass
class _Result:
    """One matrix's result on one batch, on the devices or the host: the shards' ``{"mask": word masks, "vals":
    value segments}`` and the segments' value counts ``nnz``, or ``{"dense": their rows}``."""

    parts: dict
    nnz: list | None = None

    @classmethod
    def of(cls, arrs: list, rows: int, shards: list, caps: dict, key: str, pack: bool) -> _Result:
        """The shards' result rows ``arrs`` as fetched: packed when ``pack`` and the masks and values ship fewer
        bytes than the dense rows, else the ``rows`` valid rows.  ``caps[key]`` is the matrix's own value
        capacity (the gene matrix's nnz must not size the window fetch)."""
        if pack:
            # the counts wait for this batch's compute; the packer packs the next batch meanwhile
            masks, nnz = sharded_mask_nnz(arrs, rows)
            caps[key] = cap = max(caps[key], round_result_cap(max(nnz)))
            item = arrs[0].element_size()
            if sum(m.numel() * m.element_size() for m in masks) + len(arrs) * cap * item \
                    < sum(a.numel() for a in arrs) * item:
                return cls({"mask": masks, "vals": sharded_compact(arrs, rows, cap)}, nnz)
        return cls({"dense": [a[: _shard_local_valid(rows, lo, hi - lo)] for a, (lo, hi) in zip(arrs, shards)]})

    def fetch(self, downloads: _Downloads, slot: int, name: str, clock: _Clock, key: str) -> _Result:
        """The result on the host, its copies started into the slot's buffers ``name_*`` and counted in ``key``."""
        clock.count(key, sum(t.numel() * t.element_size() for ts in self.parts.values() for t in ts))
        return _Result({k: [downloads.fetch(slot, f"{name}_{k}{i}", t) for i, t in enumerate(ts)]
                        for k, ts in self.parts.items()}, self.nnz)

    def fill(self, csr: _CallCsr, threads: int) -> tuple[int, int]:
        """The host result into ``csr``; returns ``(values the native fill wrote, bytes copied)``."""
        if self.nnz is None:
            rows = [p.numpy() for p in self.parts["dense"]]
            return 0, csr.put(*native.dense_to_csr(rows[0] if len(rows) == 1 else np.concatenate(rows)))
        masks = [m.numpy().view(np.uint32) for m in self.parts["mask"]]
        return csr.put_packed(masks, [v.numpy() for v in self.parts["vals"]], self.nnz, threads)


class _Packer:
    """Packs and copies up the computed batches (``pack_up``): with ``worker``, on the ``infercnv-pack`` thread,
    each submitted a batch ahead of the caller, its copy waiting for the gate of the batch taken before it; else
    inline when taken, with no wait and no gate."""

    def __init__(self, pack_up, worker: bool):
        self.pack_up = pack_up
        self.pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="infercnv-pack") if worker else None
        self.ahead = self.gate = None  # the batch submitted and not yet taken; the gate of the batch taken last

    @property
    def busy(self) -> bool:
        """A next batch is submitted and not yet taken: the thread packs beside the caller."""
        return self.ahead is not None

    def submit(self, start: int | None) -> None:
        if self.pool is not None and start is not None:
            self.ahead = self.pool.submit(self.pack_up, start, profiling.current(), self.gate)

    def take(self, start: int):
        if self.pool is None:
            return self.pack_up(start)
        with profiling.span("infercnv.wait", on="pack"):
            prepared = self.ahead.result()
        self.ahead, self.gate = None, threading.Event()
        return prepared

    def computed(self) -> None:
        """Opens the gate: the batch taken last has computed."""
        if self.gate is not None:
            self.gate.set()

    def close(self) -> None:
        if self.pool is not None:
            self.computed()
            self.pool.shutdown(wait=True, cancel_futures=True)


class _Pipeline:
    """A call's batches: each packed and copied up, computed, fetched, and assembled into ``out``, its gene values
    into ``gene_parts``, and the checkpoint; or loaded from the checkpoint.  The constructor makes what they share:
    ``slots``, the batches to compute in order, each to its upload and download slot, and, when there is one, the
    transform ``fn``, the reference on the devices and the slots' buffers (a run that only resumes builds none)."""

    def __init__(self, expr, plan, reference, columns, devices, clock: _Clock, ckpt: Path | None, *, batch_cells,
                 chunksize, cdtype, stage_dtype, use_sparse, use_result_pack, gene_values, lfc_clip,
                 dynamic_threshold, progress):
        n_cells, n_cols = expr.shape
        np_cdtype = _np_dtype(cdtype)
        self.expr, self.plan, self.clock, self.ckpt, self.progress = expr, plan, clock, ckpt, progress
        self.batch_cells, self.chunksize, self.cdtype = batch_cells, chunksize, cdtype
        self.use_sparse, self.use_result_pack = use_sparse, use_result_pack
        self.num_chunks = max(1, -(-n_cells // chunksize))
        starts = range(0, n_cells, batch_cells)
        computed = [s for s in starts if ckpt is None or not _batch_file(ckpt, s).exists()]
        self.slots = {s: i % 2 for i, s in enumerate(computed)}
        self.gpd = gene_projection_data(plan) if gene_values else None  # the gene projection
        self.out = _CallCsr(n_cells, plan.n_windows, np_cdtype)
        self.gene_parts, self.caps = [], {"x": 0, "gene": 0}  # a value capacity a matrix
        lut = _pack_lut(plan, len(columns))
        # the packers read expr's own columns through the LUT spread onto them
        self.col_lut = np.full(n_cols, -1, dtype=np.int64)
        self.col_lut[columns] = lut
        if not self.slots:
            return  # every batch resumes from the checkpoint
        if clock.stats is not None:
            t0 = time.perf_counter()
            native.library()
            if devices[0].type == "cuda" and cdtype == torch.float32:
                _build.library()
            clock.stats["compile_sec"] = time.perf_counter() - t0
        # the transform maps the shards' operands to the shards' results, as lists
        self.fn = sharded_infercnv_fn(
            plan, devices, n_ref_rows=reference.shape[0], lfc_clip=lfc_clip, dynamic_threshold=dynamic_threshold,
            num_chunks=self.num_chunks, calculate_gene_values=gene_values, dtype=cdtype,
        )
        self.refs = replicate(torch.from_numpy(pack_columns(np.asarray(reference, np_cdtype), plan, lut)), devices)

        # every batch ships this many rows, a multiple of the device count; the
        # padding rows take the sentinel chunk id num_chunks
        rows_padded = batch_cells if n_cells > batch_cells else n_cells
        rows_padded += (-rows_padded) % len(devices)
        self.width = width = packed_width(plan)
        specs = {"chunk": ((rows_padded,), torch.int64)}
        if use_sparse:
            # one nnz capacity for all batches of this run (the per-batch
            # maximum of the masked genes' nonzeros, bucket-rounded), so every
            # batch ships buffers of one size
            ptr = expr.indptr
            bounds = [(int(ptr[s]), int(ptr[min(s + batch_cells, n_cells)])) for s in starts]
            if len(columns) < n_cols:
                kept = np.zeros(n_cols, dtype=np.uint8)
                kept[columns] = 1
                batch_nnz = [native.count_in_columns(expr.indices[lo:hi], kept) for lo, hi in bounds]
            else:
                batch_nnz = [hi - lo for lo, hi in bounds]
            shared_cap = sparse_ingest.round_nnz_cap(max(batch_nnz))
            specs["cols"] = ((shared_cap,), _TORCH_INT[np.dtype(sparse_ingest.col_index_dtype(width))])
            specs["vals"] = ((shared_cap,), stage_dtype)
            specs["counts"] = ((rows_padded,), torch.int32)
        else:
            specs["x"] = ((rows_padded, width), stage_dtype)
        # compute-dtype staging for another transfer dtype; the native remap writes bfloat16 itself
        convert = stage_dtype != cdtype and not (use_sparse and stage_dtype == torch.bfloat16)
        self.scratch = np.empty(specs["vals" if use_sparse else "x"][0], np_cdtype) if convert else None
        with profiling.span("infercnv.slots"):
            self.uploads = _Uploads(devices, shard_rows(rows_padded, len(devices)), specs)
            self.downloads = _Downloads(devices)

    def pack_up(self, start: int, parent=None, after=None) -> tuple[list, int, int | None]:
        """Pack batch ``start`` into its slot and, once ``after`` is set, start its copy to the devices; returns the
        shards' ``(tensors, event)``, the rows and the values (device densify).  ``parent`` handed the batch over."""
        slot = self.slots[start]
        rows = min(self.batch_cells, self.expr.shape[0] - start)
        np_cdtype = _np_dtype(self.cdtype)
        staged = self.uploads.tensors[slot]["vals" if self.use_sparse else "x"]
        with self.clock.stage("infercnv.pack", "host_pack_sec", parent=parent):
            host = self.uploads.host(slot)
            nnz = None
            if self.use_sparse:
                # bfloat16 is written by the native remap itself; another transfer
                # dtype is converted from the compute dtype after the remap
                _, _, _, nnz = sparse_ingest.coo_from_csr_batch(
                    self.expr, self.col_lut, self.width, len(host["cols"]),
                    "bfloat16" if staged.dtype == torch.bfloat16 else np_cdtype, rows=(start, start + rows),
                    out=(host["cols"], host["vals"] if self.scratch is None else self.scratch, host["counts"][:rows]),
                )
                host["counts"][rows:] = 0
            else:
                block = host["x"] if self.scratch is None else self.scratch
                if sp.issparse(self.expr):
                    pack_csr(self.expr, self.plan, self.col_lut, dtype=np_cdtype, rows=(start, start + rows),
                             out=block[:rows])
                else:
                    raw = _ensure_array(np.asarray(self.expr[start : start + rows]))
                    pack_columns(raw, self.plan, self.col_lut, dtype=np_cdtype, out=block[:rows])
                block[rows:] = 0
            if self.scratch is not None:
                # round to the transfer dtype on the host (torch's
                # round-to-nearest-even); the device upcasts again
                staged.copy_(torch.from_numpy(self.scratch))
            chunk = host["chunk"]
            np.floor_divide(np.arange(start, start + len(chunk)), self.chunksize, out=chunk)
            chunk[rows:] = self.num_chunks
        if after is not None:
            with profiling.span("infercnv.wait", parent=parent, on="memory"):
                after.wait()
        with self.clock.stage("infercnv.h2d", "h2d_sec", parent=parent):
            devs = self.uploads.to_device(slot)
            self.clock.count("h2d_bytes", self.uploads.nbytes)
        return devs, rows, nnz

    def compute(self, devs: list, rows: int, nnz) -> tuple[_Result, _Result | None]:
        """The window and gene results of a batch's uploads, on the devices."""
        parts = [self.uploads.ready(dev, event) for dev, event in devs]
        with self.clock.stage("infercnv.launch", "compute_sec"):
            if self.use_sparse:
                densify = sparse_ingest.densify
                xs = [densify(p["cols"], p["vals"], p["counts"], nnz, self.width, self.cdtype) for p in parts]
            else:
                xs = [p["x"] for p in parts]
            x, g = self.fn(xs, self.refs, [p["chunk"] for p in parts])
            shards, pack = self.uploads.shards, self.use_result_pack
            return (_Result.of(x, rows, shards, self.caps, "x", pack),
                    None if self.gpd is None else _Result.of(g, rows, shards, self.caps, "gene", pack))

    def fetch(self, start: int, x: _Result, g: _Result | None) -> tuple:
        """Start batch ``start``'s copies to the host; returns the arguments of :meth:`assemble`."""
        with self.clock.stage("infercnv.d2h", "d2h_sec"):
            x = x.fetch(self.downloads, self.slots[start], "x", self.clock, "d2h_bytes")
            if g is not None:
                g = g.fetch(self.downloads, self.slots[start], "gene", self.clock, "gene_d2h_bytes")
            return start, x, g, self.downloads.record()

    def assemble(self, start: int, x: _Result, g: _Result | None, copies: list, beside_packer: bool) -> None:
        """Wait for batch ``start``'s ``copies``, fill it into ``out`` and ``gene_parts``, checkpoint it."""
        if copies:
            with profiling.span("infercnv.wait", on="copies"):
                for event in copies:
                    event.synchronize()
        row0 = self.out.rows
        # the native fill's threads, or the dense scan's
        threads = max(1, torch.get_num_threads()) if x.nnz is None else _csr_fill_threads(sum(x.nnz), beside_packer)
        with self.clock.stage("infercnv.csr", "csr_sec", threads=threads):
            written, copied = x.fill(self.out, threads)
            self.clock.count("csr_nnz", written)
            self.clock.count("csr_copied_bytes", copied)
        gene = None
        if g is not None:
            with self.clock.stage("infercnv.gene_unpack", "gene_unpack_sec"):
                # per-gene values are consumed (and checkpointed) dense, copied
                # out of the reused host buffer
                if g.nnz is None:
                    gene = np.concatenate([p.numpy() for p in g.parts["dense"]])
                else:
                    genes = _CallCsr(self.out.rows - row0, self.gpd.total, _np_dtype(self.cdtype))
                    g.fill(genes, _csr_fill_threads(sum(g.nnz), beside_packer))
                    gene = genes.matrix().toarray()
                self.gene_parts.append(gene)
        if self.ckpt is not None:
            with self.clock.stage("infercnv.checkpoint", "csr_sec"):
                shape = (self.out.rows - row0, self.plan.n_windows)
                _save_batch(self.ckpt, start, self.out.batch(row0, self.out.rows), shape, gene)

    def load(self, start: int) -> None:
        """Batch ``start`` from the checkpoint into ``out`` and ``gene_parts``."""
        with profiling.span("infercnv.resume"), np.load(_batch_file(self.ckpt, start)) as z:
            part = z["data"], z["indices"], z["indptr"]
            if self.gpd is not None:
                self.gene_parts.append(z["gene"])
        with self.clock.stage("infercnv.csr", "csr_sec", threads=1):
            self.clock.count("csr_copied_bytes", self.out.put(*part))

    def report(self, done: int, t0: float) -> None:
        """``progress`` (as in :func:`infercnv`) after the first ``done`` cells."""
        if self.progress is False:
            return
        n_cells = self.expr.shape[0]
        elapsed = time.perf_counter() - t0
        rate = done / max(elapsed, 1e-9)
        eta = (n_cells - done) / max(rate, 1e-9)
        msg = f"infercnv: {done:,}/{n_cells:,} cells ({rate:,.0f} cells/s, ETA {eta:.0f}s)"
        if callable(self.progress):
            self.progress({"cells_done": done, "cells_total": n_cells, "elapsed_sec": elapsed,
                           "cells_per_sec": rate, "eta_sec": eta})
        elif self.progress is True:
            print(msg, file=sys.stderr, flush=True)
        else:
            info(msg)

    def run(self) -> None:
        """Every batch in cell order: with more than one to compute and no ``stats``, the packer thread packs
        and copies batch k+1 while the device computes batch k and this thread assembles batch k-1."""
        packer = _Packer(self.pack_up, worker=self.clock.stats is None and len(self.slots) > 1)
        upcoming = iter(self.slots)  # the batches to compute, in order
        t0, pending = time.perf_counter(), None
        try:
            packer.submit(next(upcoming, None))
            for start in range(0, self.expr.shape[0], self.batch_cells):
                fetched = None
                if start in self.slots:
                    devs, rows, nnz = packer.take(start)
                    # the next computed batch goes to the packer before this one computes
                    packer.submit(next(upcoming, None))
                    results = self.compute(devs, rows, nnz)
                    del devs
                    # only now may the next batch's copy allocate its device buffers: this compute has returned
                    # and freed its dense block, so the device's peak is one batch's, whatever the threads' pace
                    packer.computed()
                    fetched = self.fetch(start, *results)
                    del results
                # the previous batch is assembled once this one's copies have started, or before a resumed batch
                # loads, so the rows stay in cell order
                if pending is not None:
                    self.assemble(*pending, packer.busy)
                pending = fetched
                if fetched is None:
                    self.load(start)
                self.report(min(start + self.batch_cells, self.expr.shape[0]), t0)
            if pending is not None:
                self.assemble(*pending, packer.busy)
        finally:
            # a failed batch must not leave the packer waiting for its compute
            packer.close()


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
    device,
    device_densify: bool | None = None,
    stats: dict | None = None,
    progress=False,
    compress_results=None,
    calculate_gene_values: bool = False,
    checkpoint_dir=None,
    transfer_dtype=None,
    columns: np.ndarray | None = None,
):
    """Run the full pipeline; returns ``(chr_pos, csr result, per-gene matrix or None)``.

    The per-gene matrix is (cells, masked genes), NaN for uncovered genes.
    ``device`` is one torch device or a list of them, one per cell shard.

    ``columns`` — the increasing positions in ``expr``'s columns of ``var``'s
    rows (the masked genes); the packers read ``expr`` in place through them
    and skip the other columns.  ``None`` means ``expr``'s columns are
    ``var``'s rows.  ``reference`` is over the masked genes either way.

    ``stats`` (optional) — a dict that receives a per-stage breakdown:
    ``host_pack_sec``, ``h2d_sec``, ``h2d_bytes``, ``compute_sec``,
    ``d2h_sec``, ``d2h_bytes`` (the window matrix), ``csr_sec`` (with the
    checkpoint writes), ``csr_nnz`` and ``csr_copied_bytes`` (the counters of
    :class:`_CallCsr`'s fill), ``compile_sec`` (building and loading the native
    packer and the CUDA kernels), ``mode``, ``result_pack`` and, when set,
    ``transfer_dtype``; with gene values also ``gene_d2h_bytes`` (inside
    ``d2h_sec``), ``gene_unpack_sec`` (bitmask to dense on the host) and
    ``gene_scatter_sec`` (to the masked var axis).  Collecting it runs the
    batches one after another and synchronises the device between stages,
    so the stages are exact and their total bounds the pipelined wall time.
    Each ``*_sec`` key times the stage spans of ``profiling`` that share its
    stage (``infercnv.pack``, ``infercnv.h2d``, ``infercnv.launch``,
    ``infercnv.d2h``, ``infercnv.csr`` with ``infercnv.checkpoint``, ...),
    and each ``*_bytes`` key sums the counter of its name.

    ``checkpoint_dir`` and ``transfer_dtype`` as in :func:`infercnv`.
    """
    expr = _as_csr(expr)  # batches are row ranges of the CSR arrays
    n_cells, n_cols = expr.shape
    n_genes = len(var)
    if n_cells == 0:
        raise ValueError("adata contains no cells — nothing to infer CNV from.")
    columns = np.arange(n_cols) if columns is None else np.asarray(columns, dtype=np.int64)
    if len(columns) != n_genes or (n_genes and (columns[0] < 0 or columns[-1] >= n_cols)) \
            or np.any(np.diff(columns) <= 0):
        raise ValueError(f"var's {n_genes} genes need as many increasing positions among expr's {n_cols} columns")
    with profiling.span("infercnv.plan"):
        plan = build_window_plan(var, window_size, step)
    if plan.n_windows == 0:
        raise ValueError("No usable chromosomes found (need `chr*` prefixed chromosome annotations).")

    with profiling.span("infercnv.setup"):
        cdtype = _pick_dtype(expr, dtype)
        tdt, tdt_name = _transfer_dtype(transfer_dtype)
        if batch_cells is None:
            # target ≈1.5 GB of dense input per batch, rounded to whole chunks
            batch_cells = max(1, int(1.5e9 / max(1, n_genes * 4)))
        batch_cells = max(chunksize, (batch_cells // chunksize) * chunksize)
        batch_cells = min(batch_cells, ((n_cells + chunksize - 1) // chunksize) * chunksize)
        devices = list(device) if isinstance(device, (list, tuple)) else [device]
        sharded = len(devices) > 1
        use_sparse = device_densify is not False and sp.issparse(expr) and not sharded
        if device_densify and sharded:
            warn("device_densify is not supported on several devices; using the host packer")
        use_result_pack = compress_results is True or (compress_results is None and dynamic_threshold is not None)
        _LAST_RUN_INFO.clear()
        _LAST_RUN_INFO.update({"n_devices": len(devices), "sharded": sharded, "device_densify": use_sparse})

        ckpt = None
        if checkpoint_dir is not None:
            # the fingerprint is the JAX package's digest of the masked matrix
            masked = _masked_copy(expr, columns) if n_genes < n_cols else expr
            fp = _ckpt_fingerprint(
                masked, var, reference, n_cells, n_genes, window_size, step, lfc_clip, dynamic_threshold,
                chunksize, calculate_gene_values, batch_cells, cdtype, tdt_name,
            )
            ckpt = _open_checkpoint(checkpoint_dir, fp, n_cells, batch_cells)
        if stats is not None:
            stats["mode"] = "device_densify" if use_sparse else "host_pack"
            stats["result_pack"] = use_result_pack
            if tdt_name is not None:
                stats["transfer_dtype"] = tdt_name
            stats["compile_sec"] = 0.0
        clock = _Clock(stats, devices if devices[0].type == "cuda" else ())
        pipeline = _Pipeline(
            expr, plan, reference, columns, devices, clock, ckpt, batch_cells=batch_cells, chunksize=chunksize,
            cdtype=cdtype, stage_dtype=cdtype if tdt is None else tdt, use_sparse=use_sparse,
            use_result_pack=use_result_pack, gene_values=calculate_gene_values, lfc_clip=lfc_clip,
            dynamic_threshold=dynamic_threshold, progress=progress,
        )
    pipeline.run()

    with profiling.span("infercnv.stack"):
        res = pipeline.out.matrix()
    per_gene = None
    if pipeline.gpd is not None:
        gene_parts = pipeline.gene_parts
        with clock.stage("infercnv.gene_scatter", "gene_scatter_sec"):
            used = np.concatenate(gene_parts, axis=0) if len(gene_parts) > 1 else gene_parts[0]
            # device gene columns are in coverage-group order; scatter them to the
            # masked var axis (uncovered genes stay NaN, as in the reference's reindex)
            per_gene = np.full((n_cells, n_genes), np.nan, dtype=used.dtype)
            per_gene[:, plan.used_genes[pipeline.gpd.covered_sorted]] = used
    return plan.chr_pos, res, per_gene


def _get_reference(
    adata,
    reference_key: str | None,
    reference_cat,
    reference: np.ndarray | None,
    layer: str | None,
) -> np.ndarray:
    """Reference-baseline extraction (behavior matches reference tl/_infercnv.py:359-408).

    The means are the plain :func:`_mean0` of each category's rows, bit for
    bit; :func:`_slot_means` says which input takes one native pass for them.
    The span open around the call gets the attrs ``path`` and ``categories``
    and the counter ``reference_nnz`` (``profiling``).
    """
    X = adata.X if layer is None else adata.layers[layer]
    if reference is None:
        if reference_key is None or reference_cat is None:
            warn(
                "No reference given — falling back to the mean over ALL cells as the baseline; "
                "pass `reference` or `reference_key`+`reference_cat` for meaningful CNV calls."
            )
            reference = _slot_means(X, None, np.array([X.shape[0]]))
        else:
            cats = np.array([reference_cat] if isinstance(reference_cat, str) else list(reference_cat))
            slot, of_cat, counts = _reference_slots(adata.obs[reference_key], cats)
            # error text is observable API surface (reference tl/_infercnv.py:388-392)
            absent = cats[counts[of_cat] == 0]
            if absent.size:
                raise ValueError(f"Categories {absent} do not occur in `adata.obs[{reference_key!r}]`.")
            reference = _slot_means(X, slot, counts)[of_cat]

    reference = np.asarray(reference)
    if reference.ndim == 1:
        reference = reference[np.newaxis, :]
    if reference.shape[1] != adata.shape[1]:
        raise ValueError("The reference baseline has a different gene count than `adata`.")
    return reference


def _reference_slots(labels: pd.Series, cats: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(slot, of_cat, counts)``: each cell's slot among the distinct ``cats`` (int32, -1 for none), the slot of
    each of ``cats``, and each slot's cells.

    A cell is in a category's slot where its label ``==`` the category, as
    ``np.isin`` decides presence.  A categorical column maps the categories
    to their codes (``get_indexer``), so its labels are never made into
    objects; any other column compares its labels with each category.
    """
    distinct: dict = {}
    of_cat = np.array([distinct.setdefault(c, len(distinct)) for c in cats.tolist()], dtype=np.intp)
    if isinstance(labels.dtype, pd.CategoricalDtype):
        pos = labels.cat.categories.get_indexer(list(distinct))
        lut = np.full(len(labels.cat.categories) + 1, -1, dtype=np.int32)  # the last entry: code -1, no label
        lut[pos[pos >= 0]] = np.flatnonzero(pos >= 0)
        slot = lut[labels.cat.codes.to_numpy()]
    else:
        values = np.asarray(labels.values)
        slot = np.full(len(values), -1, dtype=np.int32)
        for s, cat in enumerate(distinct):
            slot[values == cat] = s
    return slot, of_cat, np.bincount(slot[slot >= 0], minlength=len(distinct))


def _slot_means(X, slot: np.ndarray | None, counts: np.ndarray) -> np.ndarray:
    """``(len(counts), genes)``: the column means of each slot's rows of ``X`` (``slot`` None: all rows, one slot).

    CSR with float32, float64 or integer values and int32 column ids, and
    rows in every slot, takes one native pass over the caller's arrays
    (``native.reference_sums``, each term ``x * (1 / n)`` in the mean's
    dtype, rows in ascending order): scipy's own arithmetic, so bit-equal to
    :func:`_mean0` of the slot's rows.  Other input takes :func:`_mean0`.
    (scipy 1.18 first sums a row's entries of one column, so where float
    values repeat a column id in a row, its last bits can differ.)
    """
    data = X.data if sp.issparse(X) and X.format == "csr" else None
    if data is None or X.indices.dtype != np.int32 or not data.dtype.isnative or not counts.all() \
            or not (data.dtype in (np.float32, np.float64) or data.dtype.kind in "iu"):
        profiling.tag(path="plain", categories=len(counts))
        profiling.count("reference_nnz", 0)
        if slot is None:
            return _mean0(X)[np.newaxis, :]
        return np.vstack([_mean0(X[slot == s, :]) for s in range(len(counts))])
    profiling.tag(path="native", categories=len(counts))
    dtype = np.float32 if data.dtype == np.float32 else np.float64
    if slot is None:
        slot = np.zeros(X.shape[0], dtype=np.int32)
    sums, summed = native.reference_sums(X.indptr, X.indices, data, slot, (1.0 / counts).astype(dtype), X.shape[1])
    profiling.count("reference_nnz", summed)
    return sums


def _mean0(X) -> np.ndarray:
    """Column means as a 1-D array, in the input's float dtype (float64 for integer input), for dense or sparse
    input."""
    if sp.issparse(X):
        return np.asarray(X.mean(axis=0)).ravel()
    return np.asarray(np.mean(np.asarray(X), axis=0)).ravel()
