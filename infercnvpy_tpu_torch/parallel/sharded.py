"""The infercnv transform over cell shards (counterpart of ``infercnvpy_tpu/parallel/sharded.py``).

The JAX package ``shard_map``s the transform and ``psum``s each chunk's
partial sums across devices (``infercnvpy_tpu/ops/infercnv_kernel.py:363-366,
428-431``), so N devices match one only to rounding.  Here each shard runs the
per-row front (``ops.infercnv_kernel.build_infercnv_front``: the fused kernel
for f32 on a CUDA device) on its own device, every shard's front launched
before any result is read, so the devices overlap.  The fronts' per-row sums
and sums² (2 × 4 bytes a cell in f32) are gathered in row order onto the first
device, where the one-device ``chunk_threshold`` runs on their concatenation;
each shard then takes its slice of the thresholds through the back (the gene
kernel with gene values, then the gate).  A row's front depends on that row
alone, so N shards give the bits of one device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..genome.plan import WindowPlan
from ..ops.infercnv_kernel import build_infercnv_back, build_infercnv_front
from .mesh import cell_mesh, mesh_key, pad_rows, replicate, shard_rows

__all__ = ["sharded_infercnv_fn", "run_sharded_infercnv"]

#: built sharded transforms by (plan, devices, parameters); ``tl.clear_transform_caches`` empties it
_BUILD_CACHE: dict = {}


def sharded_infercnv_fn(
    plan: WindowPlan,
    devices=None,
    *,
    n_ref_rows: int,
    lfc_clip: float = 3.0,
    dynamic_threshold: float | None = 1.5,
    num_chunks: int = 1,
    calculate_gene_values: bool = False,
    dtype: torch.dtype = torch.float32,
):
    """Build the infercnv transform over the cell shards of ``devices`` (``cell_mesh``'s list).

    Returns ``fn(xs, refs, chunk_ids) -> (x_res, gene_res)``: each argument is
    a list aligned with the devices (shard ``i``'s packed rows, the packed
    baseline and the shard's chunk ids, all on device ``i``), each result a
    list of the shards' gated windows on their devices (``gene_res`` is
    ``None`` without gene values).  The shards hold contiguous row ranges in
    device order; chunk semantics are global (ids from global cell indices,
    id ``num_chunks`` for padding rows), so chunks may cross shards.
    """
    devices = cell_mesh(devices)
    key = (
        plan.cache_key, mesh_key(devices), int(n_ref_rows), float(lfc_clip),
        None if dynamic_threshold is None else float(dynamic_threshold),
        int(num_chunks), bool(calculate_gene_values), str(dtype),
    )
    cached = _BUILD_CACHE.get(key)
    if cached is not None:
        return cached

    front = build_infercnv_front(plan, n_ref_rows=n_ref_rows, lfc_clip=lfc_clip, dtype=dtype)
    threshold, finish = build_infercnv_back(
        plan, dynamic_threshold=dynamic_threshold, num_chunks=num_chunks, calculate_gene_values=calculate_gene_values
    )
    home = devices[0]

    def fn(xs, refs, chunk_ids):
        if not len(xs) == len(refs) == len(chunk_ids) == len(devices):
            raise ValueError(f"{len(devices)} shards, got {len(xs)} / {len(refs)} / {len(chunk_ids)} operands")
        fronts = [front(x, r) for x, r in zip(xs, refs)]
        row_thr = threshold(
            torch.cat([rs.to(home) for _, rs, _ in fronts]),
            torch.cat([rsq.to(home) for _, _, rsq in fronts]),
            torch.cat([c.to(home) for c in chunk_ids]),
        )
        out, start = [], 0
        for x_res, _, _ in fronts:
            stop = start + x_res.shape[0]
            out.append(finish(x_res, None if row_thr is None else row_thr[start:stop].to(x_res.device)))
            start = stop
        gene = [g for _, g in out] if calculate_gene_values else None
        return [x for x, _ in out], gene

    _BUILD_CACHE[key] = fn
    return fn


def run_sharded_infercnv(fn, devices, x: np.ndarray, ref: np.ndarray, chunk_ids: np.ndarray):
    """Pad the cell axis to the device count, place the shards, run ``fn``; numpy ``(x_res, gene_res)``.

    As ``infercnvpy_tpu/parallel/sharded.py:240-254``: padding rows are zeros
    with the chunk id ``chunk_ids.max() + 1``, and are cut off the results.
    """
    devices = cell_mesh(devices)
    n_dev = len(devices)
    n = x.shape[0]
    pad = (-n) % n_dev
    x = pad_rows(np.asarray(x), n_dev)
    chunk_ids = np.asarray(chunk_ids)
    if pad:
        chunk_ids = np.concatenate([chunk_ids, np.full(pad, chunk_ids.max() + 1, chunk_ids.dtype)])
    ranges = shard_rows(x.shape[0], n_dev)
    xs = [torch.from_numpy(x[a:b]).to(d) for d, (a, b) in zip(devices, ranges)]
    cids = [torch.from_numpy(chunk_ids[a:b]).to(d) for d, (a, b) in zip(devices, ranges)]
    x_res, gene_res = fn(xs, replicate(torch.from_numpy(np.asarray(ref)), devices), cids)
    x_out = torch.cat([t.cpu() for t in x_res]).numpy()[:n]
    gene_out = None if gene_res is None else torch.cat([t.cpu() for t in gene_res]).numpy()[:n]
    return x_out, gene_out
