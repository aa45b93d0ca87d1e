"""The CNV smoothing pipeline in PyTorch (counterpart of ``infercnvpy_tpu/ops/infercnv_kernel.py``).

Numerics contract (must match reference tl/_infercnv.py:411-457):

1. center against the reference baseline — single reference: plain difference;
   multiple references: *bounded* logFC (values between the per-gene min/max of
   the category means map to 0) (reference :419-434)
2. clip to ±lfc_clip (reference :435-436)
3. pyramidally-weighted running mean along genomic position, per chromosome,
   every ``step``-th window (reference :179-244,301-343) — one strided
   window sum over the packed gene axis (see genome.plan) plus a segment mean
   for small chromosomes
4. per-cell median centering (reference :441-442)
5. noise gating at ``dynamic_threshold × std``, where the std is taken over
   each *chunk* of cells (reference :448-453), as a segmented reduction over
   ``chunk_ids``

The host packs genes into the plan's packed layout while densifying
(:func:`pack_columns` / :func:`pack_csr` in native code, with numpy
references beside them, or the device densify in ``ops.sparse_ingest``), so
the device never gathers the permutation.

The plain pipeline here (:func:`center_smooth_median`, :func:`chunk_gate`)
serves f32 on the CPU, f64 on any device, and is the oracle for the fused CUDA
kernel (``ops.fused``), which :func:`build_infercnv_front` takes for f32
tensors on a CUDA device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..genome.plan import WindowPlan
from .select import row_median_plain

__all__ = [
    "apply_gate", "build_infercnv_back", "build_infercnv_fn", "build_infercnv_front", "center",
    "center_smooth_median", "chunk_gate", "chunk_threshold", "pack_columns", "pack_columns_plain", "pack_csr",
    "pack_csr_plain", "packed_width", "small_offsets", "smooth_packed",
]


# ---------------------------------------------------------------------------
# Host-side packing (numpy)
# ---------------------------------------------------------------------------


def packed_width(plan: WindowPlan) -> int:
    """Total width of the packed layout: conv region + small-chromosome tail."""
    return plan.packed_len + len(plan.small_src)


def small_offsets(plan: WindowPlan) -> np.ndarray:
    """(n_small + 1,) packed columns bounding each small chromosome's tail slice.

    ``small_src`` is chromosome-major, so each small chromosome's genes are
    one contiguous slice of the packed tail.
    """
    return (plan.packed_len + np.concatenate([[0], np.cumsum(plan.small_counts)])).astype(np.int32)


def _pack_lut(plan: WindowPlan, n_genes: int) -> np.ndarray:
    """LUT masked-gene-index -> packed column (-1 if the gene is unused).

    The conv region uses a PHASE-MAJOR layout: gene-major packed position
    ``p`` lands at column ``(p % step) * Q + p // step`` with
    ``Q = packed_len // step`` — the packed axis is stored as its ``step``
    stride-phases, so the fused kernel reads each window tap of neighbouring
    windows from neighbouring columns.
    """
    lut = np.full(n_genes, -1, dtype=np.int64)
    pos = np.flatnonzero(plan.packed_src >= 0)
    s = plan.step
    Q = plan.packed_len // s
    p = pos
    lut[plan.packed_src[pos]] = (p % s) * Q + p // s
    lut[plan.small_src] = plan.packed_len + np.arange(len(plan.small_src))
    return lut


def pack_columns(
    x: np.ndarray, plan: WindowPlan, lut: np.ndarray | None = None, dtype=None, *, out=None
) -> np.ndarray:
    """Pack a dense (rows × masked_genes) block into the packed layout, in native code.

    ``out`` is an optional (rows, packed_width) buffer to write into.  Runs
    ``native.pack_dense`` (as ``infercnvpy_tpu/ops/infercnv_kernel.py:77``
    does); :func:`pack_columns_plain` is its numpy reference.
    """
    from .. import native

    if lut is None:
        lut = _pack_lut(plan, x.shape[1])
    out_dtype = np.dtype(dtype) if dtype is not None else np.asarray(x).dtype
    return native.pack_dense(np.asarray(x, dtype=out_dtype), lut, packed_width(plan), out=out)


def pack_columns_plain(x: np.ndarray, plan: WindowPlan, lut: np.ndarray | None = None, dtype=None) -> np.ndarray:
    """numpy reference of :func:`pack_columns`."""
    if lut is None:
        lut = _pack_lut(plan, x.shape[1])
    out_dtype = np.dtype(dtype) if dtype is not None else np.asarray(x).dtype
    out = np.zeros((x.shape[0], packed_width(plan)), dtype=out_dtype)
    used = lut >= 0
    out[:, lut[used]] = x[:, used]
    return out


def pack_csr(
    x: sp.spmatrix,
    plan: WindowPlan,
    lut: np.ndarray | None = None,
    dtype=None,
    *,
    rows: tuple[int, int] | None = None,
    out=None,
) -> np.ndarray:
    """Densify a CSR block straight into the packed layout, in native code.

    ``rows=(start, stop)`` takes that row range of ``x`` without slicing the
    matrix; ``out`` is an optional buffer to write into.  Runs
    ``native.pack_csr`` (as ``infercnvpy_tpu/ops/infercnv_kernel.py:98``
    does); :func:`pack_csr_plain` is its numpy reference.
    """
    from .. import native

    x = x.tocsr()
    if lut is None:
        lut = _pack_lut(plan, x.shape[1])
    out_dtype = np.dtype(dtype) if dtype is not None else np.result_type(x.dtype, np.float32)
    start, stop = rows if rows is not None else (0, x.shape[0])
    ptr = x.indptr[start : stop + 1]
    lo, hi = int(ptr[0]), int(ptr[-1])
    data = x.data[lo:hi].astype(out_dtype, copy=False)
    return native.pack_csr(ptr - lo, x.indices[lo:hi], data, lut, packed_width(plan), out=out)


def pack_csr_plain(x: sp.spmatrix, plan: WindowPlan, lut: np.ndarray | None = None, dtype=None) -> np.ndarray:
    """numpy reference of :func:`pack_csr`."""
    x = x.tocsr()
    if lut is None:
        lut = _pack_lut(plan, x.shape[1])
    out_dtype = np.dtype(dtype) if dtype is not None else np.result_type(x.dtype, np.float32)
    new_cols = lut[x.indices]
    keep = new_cols >= 0
    rows = np.repeat(np.arange(x.shape[0]), np.diff(x.indptr))[keep]
    out = np.zeros((x.shape[0], packed_width(plan)), dtype=out_dtype)
    out[rows, new_cols[keep]] = x.data[keep]
    return out


# ---------------------------------------------------------------------------
# Plain device pipeline (torch; any device, f32 or f64)
# ---------------------------------------------------------------------------


def center(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Step 1: reference centering (bounded logFC for multi-category refs)."""
    if ref.shape[0] == 1:
        return x - ref[0][None, :]
    ref_min = ref.amin(dim=0)[None, :]
    ref_max = ref.amax(dim=0)[None, :]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x > ref_max, x - ref_max, torch.where(x < ref_min, x - ref_min, zero))


def smooth_packed(xc: torch.Tensor, plan: WindowPlan) -> torch.Tensor:
    """Step 3 on packed input (phase-major conv region + small tail).

    Regular chromosomes: a DIRECT strided window sum with the normalised
    pyramid.  Window ``j``'s tap ``t`` (gene-major position ``j·step + t``)
    lies in phase ``t % step`` at offset ``j + t // step``, so each tap is one
    contiguous column slice.  The pyramid is symmetric (``w[t] ==
    w[W-1-t]``), so taps ``t`` and ``W-1-t`` are added first and weighted
    once: three elementwise ops a pair.  Elementwise ops only (no fused
    multiply-add, whose vector and scalar paths round differently): every
    window's value is then the same whatever rows share the call (a batched
    ``conv1d`` may pick another algorithm for one row than for many), which
    keeps cell shards bit-identical to one device.  The two-cumsum form is not
    used: in f32 its cancellation error over a 20k-gene row exceeds 1e-6.
    Small chromosomes: the mean of each chromosome's contiguous tail slice.
    Returns the (cells, n_windows) window matrix in final chromosome order.
    """
    parts = []
    dev = xc.device
    if plan.n_reg_windows:
        s = plan.step
        Q = plan.packed_len // s
        n_pos = Q - (-(-plan.window_size // s)) + 1  # conv output positions
        wts = plan.pyramid.astype(np.float64 if xc.dtype == torch.float64 else np.float32).tolist()
        W = len(wts)

        def tap(t):
            at = (t % s) * Q + t // s
            return xc[:, at : at + n_pos]

        y = torch.add(tap(0), tap(W - 1)).mul_(wts[0]) if W > 1 else tap(0) * wts[0]
        term = torch.empty_like(y)
        for t in range(1, W // 2):
            torch.add(tap(t), tap(W - 1 - t), out=term)
            y.add_(term.mul_(wts[t]))
        if W % 2 and W > 1:
            y.add_(torch.mul(tap(W // 2), wts[W // 2], out=term))
        parts.append(y[:, torch.as_tensor(plan.conv_gather, dtype=torch.long, device=dev)])
    if plan.n_small:
        # one contiguous slice per small chromosome: per-slice sums are deterministic
        bounds = small_offsets(plan)
        sums = [xc[:, int(a) : int(b)].sum(dim=1) for a, b in zip(bounds[:-1], bounds[1:])]
        counts = torch.as_tensor(plan.small_counts, dtype=xc.dtype, device=dev)
        parts.append(torch.stack(sums, dim=1) / counts[None, :])
    concat = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return concat[:, torch.as_tensor(plan.final_src, dtype=torch.long, device=dev)]


def center_smooth_median(
    x: torch.Tensor, ref: torch.Tensor, plan: WindowPlan, lfc_clip: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-4: ``(x_res, med)`` — median-centred windows (pre gate) and the medians."""
    xc = center(x, ref).clamp_(-lfc_clip, lfc_clip)
    smoothed = smooth_packed(xc, plan)
    med = row_median_plain(smoothed)
    return smoothed - med[:, None], med


def chunk_threshold(
    row_sum: torch.Tensor,
    row_sumsq: torch.Tensor,
    chunk_ids: torch.Tensor,
    num_chunks: int,
    n_windows: int,
    dynamic_threshold: float,
) -> torch.Tensor:
    """Step 5's threshold: ``dynamic_threshold × std(chunk)`` for every row, (cells,).

    ``chunk_ids`` (cells,) must be sorted, with values in ``[0, num_chunks]``;
    id ``num_chunks`` marks padding rows.  The per-chunk sums reduce segment by
    segment in a fixed order (no atomics), so a rerun gives identical bits.
    """
    if chunk_ids.numel() > 1 and bool((chunk_ids[1:] < chunk_ids[:-1]).any()):
        raise ValueError("chunk_ids must be sorted")
    lengths = torch.bincount(chunk_ids.long(), minlength=num_chunks + 1)
    if lengths.numel() != num_chunks + 1:
        raise ValueError(f"chunk_ids must lie in [0, {num_chunks}]")
    seg_sum = torch.segment_reduce(row_sum, "sum", lengths=lengths)
    seg_sq = torch.segment_reduce(row_sumsq, "sum", lengths=lengths)
    seg_n = (lengths * n_windows).to(row_sum.dtype).clamp_min(1)
    mean = seg_sum / seg_n
    var = (seg_sq / seg_n - mean * mean).clamp_min(0)
    thr = dynamic_threshold * torch.sqrt(var)
    return thr[chunk_ids.long()]


def apply_gate(x: torch.Tensor, row_thr: torch.Tensor) -> torch.Tensor:
    """Zero ``|x| < row_thr`` row by row."""
    return torch.where(x.abs() < row_thr[:, None], torch.zeros((), dtype=x.dtype, device=x.device), x)


def chunk_gate(
    x_res: torch.Tensor,
    row_sum: torch.Tensor,
    row_sumsq: torch.Tensor,
    chunk_ids: torch.Tensor,
    num_chunks: int,
    dynamic_threshold: float,
) -> torch.Tensor:
    """Step 5: zero ``|x| < dynamic_threshold × std(chunk)`` (see :func:`chunk_threshold`)."""
    row_thr = chunk_threshold(row_sum, row_sumsq, chunk_ids, num_chunks, x_res.shape[1], dynamic_threshold)
    return apply_gate(x_res, row_thr)


def build_infercnv_front(plan: WindowPlan, *, n_ref_rows: int, lfc_clip: float, dtype: torch.dtype = torch.float32):
    """The per-row front of the transform: ``front(x_packed, ref_packed) -> (x_res, row_sum, row_sumsq)``.

    Steps 1-4 and each row's sum and sum² of the median-centred windows.
    f32 goes through ``ops.fused.fused_center_smooth_median``: the CUDA kernel
    for a CUDA tensor, its plain version for a CPU tensor.  Every other dtype
    takes the plain pipeline on the tensor's device.  Each row's outputs
    depend on that row alone, not on the rows that share the call, so a cell
    shard gives the same bits as the whole batch.
    """
    from .fused import fused_center_smooth_median

    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    n_ref = int(n_ref_rows)

    def front(x: torch.Tensor, ref: torch.Tensor):
        x = x.to(dtype)
        ref = ref.to(dtype)
        if dtype == torch.float32:
            if n_ref == 1:
                ref2 = torch.cat([ref, ref], dim=0)
            else:
                ref2 = torch.stack([ref.amin(dim=0), ref.amax(dim=0)])
            x_res, rs, rsq, _med = fused_center_smooth_median(
                x.contiguous(), ref2.contiguous(), plan, lfc_clip=lfc_clip, n_ref=min(n_ref, 2)
            )
        else:
            x_res, _med = center_smooth_median(x, ref, plan, lfc_clip)
            rs = x_res.sum(dim=1)
            rsq = (x_res * x_res).sum(dim=1)
        return x_res, rs, rsq

    return front


def build_infercnv_back(
    plan: WindowPlan, *, dynamic_threshold: float | None, num_chunks: int, calculate_gene_values: bool = False
):
    """The back of the transform: ``(threshold, finish)``.

    * ``threshold(row_sum, row_sumsq, chunk_ids) -> row_thr`` — step 5's
      per-row threshold (:func:`chunk_threshold`) over ALL rows of the batch,
      or ``None`` without a gate;
    * ``finish(x_res, row_thr) -> (x_res, gene_res)`` — the gene projection
      (``ops.gene.gene_project``: the CUDA kernel for f32 on a CUDA device)
      from the ungated windows, then the gate, on any row range with its
      slice of ``row_thr``.
    """
    from .gene import gene_project, gene_projection_data

    gpd = gene_projection_data(plan) if calculate_gene_values else None

    def threshold(rs: torch.Tensor, rsq: torch.Tensor, chunk_ids: torch.Tensor):
        if dynamic_threshold is None:
            return None
        return chunk_threshold(rs, rsq, chunk_ids, num_chunks, plan.n_windows, float(dynamic_threshold))

    def finish(x_res: torch.Tensor, row_thr: torch.Tensor | None):
        gene_res = None
        if gpd is not None:
            gene_res = gene_project(x_res, row_thr, gpd, gate=row_thr is not None)
        if row_thr is not None:
            x_res = apply_gate(x_res, row_thr)
        return x_res, gene_res

    return threshold, finish


def build_infercnv_fn(
    plan: WindowPlan,
    *,
    n_ref_rows: int,
    lfc_clip: float,
    dynamic_threshold: float | None,
    num_chunks: int,
    calculate_gene_values: bool = False,
    dtype: torch.dtype = torch.float32,
):
    """Build the end-to-end transform over PACKED input.

    Returns ``fn(x_packed, ref_packed, chunk_ids) -> (x_res, gene_res)``:

    * ``x_packed``   — (cells, packed_width(plan)) dense packed expression
    * ``ref_packed`` — (n_ref_rows, packed_width(plan)) packed baseline(s)
    * ``chunk_ids``  — (cells,) sorted integer ids; cells with the same id
      share a noise-gate std.  Ids lie in ``[0, num_chunks]``; id
      ``num_chunks`` marks padding rows, which take a threshold from an unused
      segment and must be discarded by the caller.

    The transform is :func:`build_infercnv_front` (the fused kernel for f32
    on a CUDA device) followed by :func:`build_infercnv_back`;
    ``parallel.sharded_infercnv_fn`` runs the same two on cell shards.

    ``gene_res`` is ``None`` unless ``calculate_gene_values``; then it is the
    (cells, n_covered) per-gene matrix of ``ops.gene.gene_project``, computed
    from the median-centred windows before the gate and gated with the same
    per-row threshold, its columns in ``gene_projection_data(plan).covered_sorted``
    order.
    """
    front = build_infercnv_front(plan, n_ref_rows=n_ref_rows, lfc_clip=lfc_clip, dtype=dtype)
    threshold, finish = build_infercnv_back(
        plan, dynamic_threshold=dynamic_threshold, num_chunks=num_chunks, calculate_gene_values=calculate_gene_values
    )

    def fn(x: torch.Tensor, ref: torch.Tensor, chunk_ids: torch.Tensor):
        x_res, rs, rsq = front(x, ref)
        return finish(x_res, threshold(rs, rsq, chunk_ids))

    return fn
