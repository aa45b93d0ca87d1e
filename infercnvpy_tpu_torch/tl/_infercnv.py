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

import contextlib
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

from .. import profiling
from .._util import _ensure_array, info, pick_devices, warn
from ..genome.plan import build_window_plan
from ..ops.gene import gene_projection_data
from ..ops.infercnv_kernel import _pack_lut, pack_columns, pack_csr, packed_width
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
    blocks (its ``on``: ``"pack"``, ``"copies"`` or ``"compute"``), and the
    counters ``pinned_bytes``, ``h2d_bytes`` and ``d2h_bytes``.
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

        with profiling.span("infercnv.subset"):
            sub = adata[:, keep]
            expr = sub.X if layer is None else sub.layers[layer]
            if sp.issparse(expr):
                expr = expr.tocsr()
            var = sub.var.loc[:, ["chromosome", "start", "end"]]

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


def _stage(name: str, stats: dict | None, key: str, devices=(), **attrs):
    """The span ``name`` (``profiling.span``); with ``stats``, also the stage clock.

    The clock synchronizes the CUDA ``devices`` at both ends of the stage and
    adds its wall to ``stats[key]``, so a serialized run's stages are exact.
    """
    span = profiling.span(name, **attrs)
    return span if stats is None else _clocked(span, stats, key, devices)


@contextlib.contextmanager
def _clocked(span, stats: dict, key: str, devices):
    with span:
        for d in devices:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        yield
        for d in devices:
            torch.cuda.synchronize(d)
        stats[key] = stats.get(key, 0.0) + (time.perf_counter() - t0)


def _reindex_genes(per_gene: np.ndarray, obs_names, masked_names, var_names, stats: dict | None = None) -> np.ndarray:
    """Masked-var-axis gene values -> all of ``var_names``, NaN for the genes left out.

    As the JAX package does it (``infercnvpy_tpu/tl/_infercnv.py:161-166``):
    through a pandas reindex.  ``stats`` receives ``gene_reindex_sec``.
    """
    with _stage("infercnv.gene_reindex", stats, "gene_reindex_sec"):
        df = pd.DataFrame(per_gene, index=obs_names, columns=masked_names)
        return df.reindex(columns=var_names, fill_value=np.nan).values


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


def _host_rows(parts: list[torch.Tensor]) -> np.ndarray:
    """The shards' host row blocks as one array (the one block itself for one shard)."""
    return parts[0].numpy() if len(parts) == 1 else np.concatenate([p.numpy() for p in parts])


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
    device,
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
    ``device`` is one torch device or a list of them, one per cell shard.

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
    Each ``*_sec`` key times the stage spans of ``profiling`` that share its
    stage (``infercnv.pack``, ``infercnv.h2d``, ``infercnv.launch``,
    ``infercnv.d2h``, ``infercnv.csr`` with ``infercnv.checkpoint``, ...),
    and each ``*_bytes`` key sums the counter of its name.

    ``checkpoint_dir`` and ``transfer_dtype`` as in :func:`infercnv`.
    """
    if sp.issparse(expr):
        expr = expr.tocsr()  # batches are row ranges of the CSR arrays
    n_cells, n_genes = expr.shape
    if n_cells == 0:
        raise ValueError("adata contains no cells — nothing to infer CNV from.")
    with profiling.span("infercnv.plan"):
        plan = build_window_plan(var, window_size, step)
    if plan.n_windows == 0:
        raise ValueError("No usable chromosomes found (need `chr*` prefixed chromosome annotations).")

    timing = stats is not None
    with profiling.span("infercnv.setup"):
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
        devices = list(device) if isinstance(device, (list, tuple)) else [device]
        n_dev = len(devices)
        sharded = n_dev > 1
        # every batch ships this many rows, a multiple of the device count; the
        # padding rows take the sentinel chunk id num_chunks
        rows_padded = batch_cells if n_cells > batch_cells else n_cells
        rows_padded += (-rows_padded) % n_dev
        shards = shard_rows(rows_padded, n_dev)

        use_sparse = device_densify is not False and sp.issparse(expr) and not sharded
        if device_densify and sharded:
            warn("device_densify is not supported on several devices; using the host packer")
        use_result_pack = compress_results is True or (compress_results is None and dynamic_threshold is not None)
        on_cuda = devices[0].type == "cuda"
        _LAST_RUN_INFO.clear()
        _LAST_RUN_INFO.update({"n_devices": n_dev, "sharded": sharded, "device_densify": use_sparse})

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
        clocked = devices if timing and on_cuda else ()

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

        if compute_starts:
            from .. import native
            from ..ops.result_pack import (
                _shard_local_valid, mask_vals_to_csr, round_result_cap, sharded_compact, sharded_mask_nnz,
                sharded_mask_vals_to_csr,
            )
            from ..ops.sparse_ingest import coo_from_csr_batch, col_index_dtype, densify, round_nnz_cap

            # the transform is built only here: a run whose every batch resumes
            # from the checkpoint builds and launches nothing.  It maps the
            # shards' operands to the shards' results, as lists
            fn_kw = dict(
                n_ref_rows=reference.shape[0], lfc_clip=lfc_clip, dynamic_threshold=dynamic_threshold,
                num_chunks=num_chunks, calculate_gene_values=calculate_gene_values, dtype=cdtype,
            )
            fn = sharded_infercnv_fn(plan, devices, **fn_kw)

            refs = replicate(torch.from_numpy(pack_columns(np.asarray(reference, dtype=np_cdtype), plan, lut)), devices)

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
            with profiling.span("infercnv.slots"):
                uploads = _Uploads(devices, shards, specs)
                downloads = _Downloads(devices)
            chunk_base = np.arange(rows_padded, dtype=np.int64)

    def stage(name: str, key: str, **attrs):
        """The span ``name``; with ``stats``, timed into ``stats[key]`` (``_stage``)."""
        return _stage(name, stats, key, clocked, **attrs)

    def count(key: str, n: int) -> None:
        """Add ``n`` to the counter ``key`` of the open span, and with ``stats`` to ``stats[key]``."""
        profiling.count(key, n)
        if timing:
            stats[key] = stats.get(key, 0) + n

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
        with profiling.span("infercnv.resume"), np.load(_batch_file(ckpt, start)) as z:
            res_parts.append(sp.csr_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"])))
            if gpd is not None:
                gene_parts.append(z["gene"])

    if compute_starts:
        def _prepare(start, parent=None):
            """Host half of one batch: pack into its slot, start the copy to the device.

            ``parent`` is the span that handed the batch to the packer thread.
            """
            slot = slot_of[start]
            stop = min(start + batch_cells, n_cells)
            rows = stop - start
            with stage("infercnv.pack", "host_pack_sec", parent=parent):
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

            with stage("infercnv.h2d", "h2d_sec", parent=parent):
                devs = uploads.to_device(slot)
                count("h2d_bytes", uploads.nbytes)
            return devs, rows, nnz

        # one capacity per matrix: the gene matrix's nnz must not size the window fetch
        pack_caps = {"x": 0, "gene": 0}

        def _try_pack(arrs: list, cap_key: str, rows: int):
            """``("packed", masks, vals, shard_nnz)`` on the devices, or None when
            the dense fetch would ship no more bytes."""
            # the counts in sharded_mask_nnz wait for this batch's compute; the
            # worker thread packs the next batch meanwhile
            masks, nnz = sharded_mask_nnz(arrs, rows)
            pack_caps[cap_key] = max(pack_caps[cap_key], round_result_cap(max(nnz)))
            cap = pack_caps[cap_key]
            item = arrs[0].element_size()
            packed_bytes = sum(m.numel() * m.element_size() for m in masks) + len(arrs) * cap * item
            if packed_bytes >= sum(a.numel() for a in arrs) * item:
                return None
            return ("packed", masks, sharded_compact(arrs, rows, cap), nnz)

        def _payload(arrs: list, cap_key: str, rows: int):
            packed = _try_pack(arrs, cap_key, rows) if use_result_pack else None
            return packed or ("dense", [a[: _shard_local_valid(rows, lo, hi - lo)] for a, (lo, hi) in zip(arrs, shards)])

        def _compute(parts: list, rows: int, nnz):
            with stage("infercnv.launch", "compute_sec"):
                if use_sparse:
                    xs = [densify(p["cols"], p["vals"], p["counts"], nnz, width, cdtype) for p in parts]
                else:
                    xs = [p["x"] for p in parts]
                x_parts, g_parts = fn(xs, refs, [p["chunk"] for p in parts])
                x_payload = _payload(x_parts, "x", rows)
                g_payload = _payload(g_parts, "gene", rows) if gpd is not None else None
            return x_payload, g_payload

        def _fetch(payload, slot: int, name: str, bytes_key: str):
            """Start the device→host copies of one payload; returns it with host tensors."""
            packed = payload[0] == "packed"
            arrays = {"mask": payload[1], "vals": payload[2]} if packed else {"dense": payload[1]}
            host = {k: [downloads.fetch(slot, f"{name}_{k}{i}", t) for i, t in enumerate(ts)]
                    for k, ts in arrays.items()}
            count(bytes_key, sum(t.numel() * t.element_size() for ts in arrays.values() for t in ts))
            return ("packed", host["mask"], host["vals"], payload[3]) if packed else ("dense", host["dense"])

        def _unpack_csr(host, n_cols: int) -> sp.csr_matrix:
            if host[0] == "packed":
                _, masks, vals, nnz = host
                mask = _host_rows(masks).view(np.uint32)
                if len(vals) == 1:
                    return mask_vals_to_csr(mask, vals[0].numpy()[: nnz[0]], n_cols)
                return sharded_mask_vals_to_csr(mask, _host_rows(vals), nnz, n_cols)
            dense = _host_rows(host[1])
            return sp.csr_matrix(native.dense_to_csr(dense), shape=dense.shape)

        def _materialize(pending):
            """Host half of one finished batch: wait for its copies, assemble, checkpoint."""
            x_host, g_host, events, start = pending
            if events:
                with profiling.span("infercnv.wait", on="copies"):
                    for event in events:
                        event.synchronize()
            with stage("infercnv.csr", "csr_sec"):
                mat = _unpack_csr(x_host, plan.n_windows)
                res_parts.append(mat)
            g_np = None
            if g_host is not None:
                with stage("infercnv.gene_unpack", "gene_unpack_sec"):
                    # per-gene values are consumed (and checkpointed) dense, copied
                    # out of the reused host buffer
                    if g_host[0] == "dense":
                        g_np = np.concatenate([p.numpy() for p in g_host[1]])
                    else:
                        g_np = _unpack_csr(g_host, gpd.total).toarray()
                    gene_parts.append(g_np)
            if ckpt is not None:
                with stage("infercnv.checkpoint", "csr_sec"):
                    _save_batch(ckpt, start, mat, g_np)

    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="infercnv-pack") if use_prefetch else None
    futures: dict = {}
    if use_prefetch:
        futures[compute_starts[0]] = pool.submit(_prepare, compute_starts[0], profiling.current())
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
                with profiling.span("infercnv.wait", on="pack"):
                    devs, rows, nnz = futures.pop(start).result()
                if next_prefetch < len(compute_starts):
                    nxt = compute_starts[next_prefetch]
                    futures[nxt] = pool.submit(_prepare, nxt, profiling.current())
                    next_prefetch += 1
            else:
                devs, rows, nnz = _prepare(start)
            x_payload, g_payload = _compute([uploads.ready(dev, event) for dev, event in devs], rows, nnz)
            del devs
            slot = slot_of[start]
            with stage("infercnv.d2h", "d2h_sec"):
                x_host = _fetch(x_payload, slot, "x", "d2h_bytes")
                g_host = _fetch(g_payload, slot, "gene", "gene_d2h_bytes") if g_payload is not None else None
                fetched = downloads.record()
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

    with profiling.span("infercnv.stack"):
        res = sp.vstack(res_parts, format="csr") if len(res_parts) > 1 else res_parts[0]
    per_gene = None
    if gpd is not None:
        with stage("infercnv.gene_scatter", "gene_scatter_sec"):
            used = np.concatenate(gene_parts, axis=0) if len(gene_parts) > 1 else gene_parts[0]
            # device gene columns are in coverage-group order; scatter them to the
            # masked var axis (uncovered genes stay NaN, as in the reference's reindex)
            per_gene = np.full((n_cells, n_genes), np.nan, dtype=used.dtype)
            per_gene[:, plan.used_genes[gpd.covered_sorted]] = used
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
