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
  for genes no window covers.

Batches run one after another; the JAX package's prefetch thread and
executable cache have no counterpart yet (ROADMAP.md, "pipelined copy
stream").
"""

from __future__ import annotations

import time
from collections.abc import Sequence

import numpy as np
import pandas as pd
import scipy.sparse as sp
import torch

from .._util import _ensure_array, info, warn
from ..genome.plan import build_window_plan
from ..ops.gene import gene_projection_data
from ..ops.infercnv_kernel import _pack_lut, build_infercnv_fn, pack_columns, pack_csr, packed_width

__all__ = ["infercnv"]


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to infercnvpy_tpu_torch yet (ROADMAP.md: {item}).")


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
        One torch device (or its name).  ``None`` takes CUDA when
        ``torch.cuda.is_available()``, else the CPU.  On CUDA, float32 runs
        through the fused kernel; other dtypes and the CPU run the plain
        PyTorch pipeline.
    device_densify
        For sparse input, ship the CSR arrays and densify on the device
        instead of packing a dense block on the host.  ``None`` (default)
        enables it for sparse input; ``False`` forces the host packer.  Does
        not affect numerics.
    progress
        ``None`` (default) logs a line per batch at verbosity >= 2; ``True``
        always prints to stderr; ``False`` disables; a callable receives a dict
        with ``cells_done / cells_total / elapsed_sec / cells_per_sec /
        eta_sec``.
    compress_results
        Fetch each batch's result as a nonzero bitmask + compacted values
        instead of the dense matrix (bit-identical CSR).  ``None`` (default)
        enables it whenever the noise gate is on; ``False`` forces the dense
        fetch.

    With ``calculate_gene_values=True`` the per-gene values go to
    ``layers[f"gene_values_{key_added}"]`` (or are returned third with
    ``inplace=False``): cells × all var genes, NaN for genes without a
    position, on excluded chromosomes, or covered by no window.

    ``checkpoint_dir``, ``transfer_dtype`` and more than one device are not
    ported yet and raise ``NotImplementedError``.
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
    if checkpoint_dir is not None:
        raise _not_ported("checkpoint_dir", "checkpoint/resume")
    if transfer_dtype is not None:
        raise _not_ported("transfer_dtype", "transfer_dtype")
    dev = _pick_device(device)

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


def _pick_device(device) -> torch.device:
    """One torch device: CUDA when available by default, as JAX takes its default backend."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise _not_ported("More than one device", "multi-device")
        device = device[0]
    return torch.device(device)


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
):
    """Run the full pipeline; returns ``(chr_pos, csr result, per-gene matrix or None)``.

    The per-gene matrix is (cells, masked genes), NaN for uncovered genes.

    ``stats`` (optional) — a dict that receives a per-stage breakdown:
    ``host_pack_sec``, ``h2d_sec``, ``h2d_bytes``, ``compute_sec``,
    ``d2h_sec``, ``d2h_bytes`` (the window matrix), ``csr_sec``,
    ``compile_sec`` (building and loading the CUDA kernels), ``mode`` and
    ``result_pack``; with gene values also ``gene_d2h_bytes`` (inside
    ``d2h_sec``), ``gene_unpack_sec`` (bitmask to dense on the host) and
    ``gene_scatter_sec`` (to the masked var axis).  Collecting it
    synchronises the device between stages.
    """
    if sp.issparse(expr):
        expr = expr.tocsr()  # batches are row slices; the nnz capacity reads indptr
    n_cells, n_genes = expr.shape
    if n_cells == 0:
        raise ValueError("adata contains no cells — nothing to infer CNV from.")
    plan = build_window_plan(var, window_size, step)
    if plan.n_windows == 0:
        raise ValueError("No usable chromosomes found (need `chr*` prefixed chromosome annotations).")

    cdtype = _pick_dtype(expr, dtype)
    np_cdtype = _np_dtype(cdtype)
    num_chunks = max(1, -(-n_cells // chunksize))

    if batch_cells is None:
        # target ≈1.5 GB of dense input per batch, rounded to whole chunks
        target = max(1, int(1.5e9 / max(1, n_genes * 4)))
        batch_cells = max(chunksize, (target // chunksize) * chunksize)
    else:
        batch_cells = max(chunksize, (batch_cells // chunksize) * chunksize)
    batch_cells = min(batch_cells, ((n_cells + chunksize - 1) // chunksize) * chunksize)

    use_sparse = device_densify is not False and sp.issparse(expr)
    use_result_pack = compress_results is True or (compress_results is None and dynamic_threshold is not None)
    timing = stats is not None
    on_cuda = device.type == "cuda"

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
        stats["compile_sec"] = 0.0
        if on_cuda and cdtype == torch.float32:
            from ..ops import _build

            t0 = time.perf_counter()
            _build.library()
            stats["compile_sec"] = time.perf_counter() - t0

    fn = build_infercnv_fn(
        plan,
        n_ref_rows=reference.shape[0],
        lfc_clip=lfc_clip,
        dynamic_threshold=dynamic_threshold,
        num_chunks=num_chunks,
        calculate_gene_values=calculate_gene_values,
        dtype=cdtype,
    )
    gpd = gene_projection_data(plan) if calculate_gene_values else None

    # host-side packing: genes land in the plan's packed layout during
    # densification, so the device never gathers the permutation
    lut = _pack_lut(plan, n_genes)
    width = packed_width(plan)
    ref_dev = torch.from_numpy(pack_columns(np.asarray(reference, dtype=np_cdtype), plan, lut)).to(device)

    shared_cap = None
    if use_sparse:
        from ..ops.sparse_ingest import coo_from_csr_batch, densify, round_nnz_cap

        # one nnz capacity for all batches of this run (the per-batch maximum,
        # bucket-rounded), so every batch ships buffers of one size
        ptr = expr.indptr
        batch_nnz = [int(ptr[min(s + batch_cells, n_cells)] - ptr[s]) for s in range(0, n_cells, batch_cells)]
        shared_cap = round_nnz_cap(max(batch_nnz))

    def _h2d(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    # one capacity per matrix: the gene matrix's nnz must not size the window fetch
    pack_caps = {"x": 0, "gene": 0}

    def _try_pack(arr: torch.Tensor, cap_key: str, rows: int):
        """``("packed", mask, vals, nnz)`` on the device, or None when the
        dense fetch would ship no more bytes."""
        from ..ops.result_pack import compact, mask_nnz, round_result_cap

        mask, nnz = mask_nnz(arr, rows)
        pack_caps[cap_key] = max(pack_caps[cap_key], round_result_cap(nnz))
        cap = pack_caps[cap_key]
        if mask.numel() * mask.element_size() + cap * arr.element_size() >= arr.numel() * arr.element_size():
            return None
        return ("packed", mask, compact(arr, rows, cap), nnz)

    def _payload(arr: torch.Tensor, cap_key: str, rows: int):
        return (_try_pack(arr, cap_key, rows) if use_result_pack else None) or ("dense", arr)

    def _fetch(payload, rows: int, bytes_key: str):
        """Device payload -> host numpy buffers (dense payloads sliced to the real rows)."""
        t0 = _tick()
        if payload[0] == "packed":
            _, mask, vals, nnz = payload
            host = ("packed", mask.cpu().numpy(), vals.cpu().numpy(), nnz)
            n_bytes = host[1].nbytes + host[2].nbytes
        else:
            host = ("dense", payload[1][:rows].cpu().numpy())
            n_bytes = host[1].nbytes
        if timing:
            stats[bytes_key] = stats.get(bytes_key, 0) + n_bytes
        _tock("d2h_sec", t0)
        return host

    def _unpack_csr(host, n_cols: int) -> sp.csr_matrix:
        if host[0] == "packed":
            from ..ops.result_pack import mask_vals_to_csr

            _, mask_np, vals_np, nnz = host
            return mask_vals_to_csr(mask_np.view(np.uint32), vals_np[:nnz], n_cols)
        return sp.csr_matrix(host[1])

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
    for start in range(0, n_cells, batch_cells):
        stop = min(start + batch_cells, n_cells)
        raw = expr[start:stop]
        rows = stop - start
        pad = batch_cells - rows if n_cells > batch_cells else 0
        rows_padded = rows + pad

        t0 = _tick()
        if use_sparse:
            cols, vals, counts, nnz = coo_from_csr_batch(raw, lut, width, shared_cap, val_dtype=np_cdtype)
            if pad:
                counts = np.concatenate([counts, np.zeros(pad, np.int32)])
            host = (cols, vals, counts)
        else:
            if sp.issparse(raw):
                block = pack_csr(raw, plan, lut, dtype=np_cdtype)
            else:
                block = pack_columns(_ensure_array(np.asarray(raw)), plan, lut, dtype=np_cdtype)
            if pad:
                block = np.vstack([block, np.zeros((pad, width), dtype=block.dtype)])
            host = (block,)
        # padding rows take the sentinel chunk id num_chunks
        chunk_ids = (start + np.arange(rows_padded)) // chunksize
        chunk_ids[rows:] = num_chunks
        _tock("host_pack_sec", t0)

        t0 = _tick()
        dev_arrays = [_h2d(a) for a in host]
        chunk_dev = _h2d(chunk_ids.astype(np.int64))
        if timing:
            stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + sum(a.nbytes for a in host) + chunk_ids.nbytes
        _tock("h2d_sec", t0)

        t0 = _tick()
        if use_sparse:
            x_dev = densify(*dev_arrays, nnz, width, cdtype)
        else:
            x_dev = dev_arrays[0]
        x_res, gene_res = fn(x_dev, ref_dev, chunk_dev)
        x_payload = _payload(x_res, "x", rows)
        g_payload = _payload(gene_res, "gene", rows) if gpd is not None else None
        _tock("compute_sec", t0)

        x_host = _fetch(x_payload, rows, "d2h_bytes")
        g_host = _fetch(g_payload, rows, "gene_d2h_bytes") if g_payload is not None else None
        t0 = _tick()
        res_parts.append(_unpack_csr(x_host, plan.n_windows))
        _tock("csr_sec", t0)
        if g_host is not None:
            t0 = _tick()
            # per-gene values are consumed dense
            gene_parts.append(g_host[1] if g_host[0] == "dense" else _unpack_csr(g_host, gpd.total).toarray())
            _tock("gene_unpack_sec", t0)
        _progress(stop)

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
