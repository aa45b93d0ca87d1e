"""Per-gene back-projection (counterpart of ``infercnvpy_tpu/ops/pallas_gene.py``).

With ``calculate_gene_values=True`` every covered gene gets the mean of the
windows that cover it, minus the cell's median over those gene values, gated
like the windows.  Genes covered by the same (first, last) window range have
identical values, so the gene axis collapses to *coverage groups*
(:class:`GeneProjectionData`): the group means are computed once, the gene
median is a weighted median over the groups (weight = genes per group), and
the result expands to gene columns at the end, in ``covered_sorted`` order.

The projection runs on the median-centred windows: the group means are
linear, so centring the windows first shifts the gene values and their median
by the same per-cell constant and the difference is the reference's.

* :func:`gene_project_plain` — plain PyTorch (any device, f32 or f64); each
  group mean is a direct sum over its ``hi - lo + 1 <= ceil(window / step)``
  windows, not a prefix-sum difference (in f32 the cumsum's cancellation over
  a 1,793-window row exceeds 1e-6);
* :func:`gene_project_cuda` — ``csrc/gene_project.cu`` (f32, CUDA);
* :func:`gene_project` — the kernel for a CUDA f32 tensor, the plain version
  for a CPU tensor and for f64 on any device; other dtypes raise.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ..genome.plan import WindowPlan
from . import _build
from .select import row_median_weighted_plain

__all__ = [
    "GeneProjectionData", "gene_projection_data", "gene_project", "gene_project_plain", "gene_project_cuda",
    "packed_gidx", "unpack_gidx",
]


@dataclass(frozen=True)
class GeneProjectionData:
    """Static coverage-group structure of a window plan (host-precomputed)."""

    n_windows: int
    g_lo: np.ndarray  #: (n_groups,) first covering window per group
    g_hi: np.ndarray  #: (n_groups,) last covering window per group
    g_counts: np.ndarray  #: (n_groups,) genes per group
    gidx_sorted: np.ndarray  #: (n_covered,) group of each output gene column (monotone)
    covered_sorted: np.ndarray  #: (n_covered,) used-gene index of each output column
    total: int  #: number of covered genes (weighted rank count)
    cache_key: str = ""  #: content digest of the plan the groups came from


    @property
    def n_groups(self) -> int:
        return int(len(self.g_lo))


#: plan.cache_key -> GeneProjectionData.  Keyed by the plan's content digest,
#: so equal plans share an entry and no plan object is pinned.
_gpd_cache: dict[str, GeneProjectionData] = {}


def gene_projection_data(plan: WindowPlan) -> GeneProjectionData:
    """Coverage groups of ``plan`` (cached by ``plan.cache_key``)."""
    key = plan.cache_key
    hit = _gpd_cache.get(key)
    if hit is not None:
        return hit
    n_win = plan.n_windows
    lo_np, hi_np = plan.gene_win_lo, plan.gene_win_hi
    covered = np.flatnonzero(lo_np >= 0)
    enc = lo_np[covered].astype(np.int64) * (n_win + 1) + hi_np[covered]
    uniq, inv = np.unique(enc, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    gpd = GeneProjectionData(
        n_windows=n_win,
        g_lo=(uniq // (n_win + 1)).astype(np.int32),
        g_hi=(uniq % (n_win + 1)).astype(np.int32),
        g_counts=np.bincount(inv, minlength=len(uniq)).astype(np.int32),
        gidx_sorted=inv[order].astype(np.int32),
        covered_sorted=covered[order].astype(np.int64),
        total=int(len(covered)),
        cache_key=key,
    )
    _gpd_cache[key] = gpd
    return gpd


def _check_inputs(x_res: torch.Tensor, row_thr: torch.Tensor | None, gpd: GeneProjectionData, gate: bool) -> None:
    if x_res.dim() != 2 or x_res.shape[1] != gpd.n_windows:
        raise ValueError(f"x_res must be (cells, {gpd.n_windows}), got {tuple(x_res.shape)}")
    if gate and (row_thr is None or tuple(row_thr.shape) != (x_res.shape[0],)):
        shape = None if row_thr is None else tuple(row_thr.shape)
        raise ValueError(f"gate=True needs row_thr of shape ({x_res.shape[0]},), got {shape}")


def gene_project_plain(
    x_res: torch.Tensor, row_thr: torch.Tensor | None, gpd: GeneProjectionData, *, gate: bool
) -> torch.Tensor:
    """Plain PyTorch per-gene projection (any device, f32 or f64).

    x_res   — (cells, n_windows) median-centred windows, before the gate
    row_thr — (cells,) gate threshold per row (read only when ``gate``)
    Returns (cells, gpd.total): gene columns in ``gpd.covered_sorted`` order,
    median-subtracted, and gated when ``gate``.
    """
    _check_inputs(x_res, row_thr, gpd, gate)
    dev, dt = x_res.device, x_res.dtype
    lo = torch.as_tensor(gpd.g_lo, dtype=torch.long, device=dev)
    hi = torch.as_tensor(gpd.g_hi, dtype=torch.long, device=dev)
    n_terms = hi - lo + 1
    # direct sum over each group's windows, in window order (as the kernel sums)
    acc = torch.zeros((x_res.shape[0], gpd.n_groups), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    for d in range(int(n_terms.max()) if gpd.n_groups else 0):
        term = x_res[:, torch.minimum(lo + d, hi)]
        acc = acc + torch.where((d < n_terms)[None, :], term, zero)
    u = acc / n_terms.to(dt)[None, :]
    u = u - row_median_weighted_plain(u, gpd.g_counts)[:, None]
    if gate:
        u = torch.where(u.abs() < row_thr.to(dt)[:, None], zero, u)
    return u[:, torch.as_tensor(gpd.gidx_sorted, dtype=torch.long, device=dev)]


#: bits of a step between neighbouring columns' groups, and of the first group, in a packed entry
STEP_BITS = 4
FIRST_BITS = 31 - 3 * STEP_BITS


def packed_gidx(gidx: np.ndarray) -> np.ndarray | None:
    """(4, stride) int32 packed copies of the column → group table, or ``None`` if it does not pack.

    The kernel writes four gene columns with one 16-byte store, from the first
    16-byte aligned address of a row on; the ``h`` columns before it are
    peeled.  Entry ``i`` of copy ``h`` holds the groups of columns
    ``h + 4i .. h + 4i + 3`` as ``(first << 12) | step1 | step2 << 4 |
    step3 << 8``, the steps being the differences between neighbouring
    columns' groups.  :func:`gene_projection_data` numbers the groups in
    column order, so its steps are 0 or 1.  A table with a negative step, a
    step of 16 or more, or 2**19 or more groups returns ``None``; the kernel
    then expands column by column.
    """
    gidx = np.asarray(gidx, dtype=np.int64)
    n = len(gidx)
    steps = np.diff(gidx)
    if n and (steps.min(initial=0) < 0 or steps.max(initial=0) >= 1 << STEP_BITS or gidx.max() >= 1 << FIRST_BITS):
        return None
    stride = max(-(-n // 4), 1)
    out = np.zeros((4, stride), dtype=np.int32)
    for h in range(4):
        n4 = max(n - h, 0) // 4
        cols = h + 4 * np.arange(n4)
        e = gidx[cols] << (3 * STEP_BITS)
        for j in range(3):
            e |= (gidx[cols + j + 1] - gidx[cols + j]) << (STEP_BITS * j)
        out[h, :n4] = e
    return out


def unpack_gidx(packed: np.ndarray, h: int, n: int) -> np.ndarray:
    """The groups of columns ``h .. h + 4 * ((n - h) // 4)`` from copy ``h``, as the kernel decodes them."""
    n4 = max(n - h, 0) // 4
    e = packed[h, :n4].astype(np.int64)
    g = np.empty((n4, 4), np.int64)
    g[:, 0] = e >> (3 * STEP_BITS)
    for j in range(3):
        g[:, j + 1] = g[:, j] + ((e >> (STEP_BITS * j)) & ((1 << STEP_BITS) - 1))
    return g.reshape(-1)


#: (plan digest of the groups, device) -> the four index tables on the device;
#: ``tl.clear_transform_caches`` empties it.
_device_tables: dict[tuple[str, str], tuple[torch.Tensor, ...]] = {}

#: threads of a gene_project block (a multiple of 32, at most 1024)
THREADS = 256


def _tables_on(gpd: GeneProjectionData, dev: torch.device) -> tuple[torch.Tensor, ...]:
    """``max_smem`` of ``dev``, then ``g_lo, g_hi, g_counts, gidx`` and the packed ``gidx`` copies (or ``None``)
    on it, uploaded once per (groups, device)."""
    digest = gpd.cache_key
    if not digest:  # groups built by hand, not by gene_projection_data
        h = hashlib.sha256()
        for a in (gpd.g_lo, gpd.g_hi, gpd.g_counts, gpd.gidx_sorted):
            h.update(np.ascontiguousarray(a).tobytes())
        digest = h.hexdigest()
    key = (digest, str(dev))
    hit = _device_tables.get(key)
    if hit is None:
        max_smem = _build.library().gene_project_max_smem()
        if max_smem < 0:
            _build.check(-max_smem, "gene_project")
        arrays = (gpd.g_lo, gpd.g_hi, gpd.g_counts, gpd.gidx_sorted, packed_gidx(gpd.gidx_sorted))
        hit = (max_smem, *(None if a is None else torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
                           for a in arrays))
        # later launches may run on other streams than the one that copied
        torch.cuda.current_stream(dev).synchronize()
        _device_tables[key] = hit
    return hit


def gene_project_cuda(
    x_res: torch.Tensor, row_thr: torch.Tensor | None, gpd: GeneProjectionData, *, gate: bool
) -> torch.Tensor:
    """Launch ``csrc/gene_project.cu`` (float32 CUDA tensors only); raises on any failure."""
    _check_inputs(x_res, row_thr, gpd, gate)
    dev = x_res.device
    if not x_res.is_cuda or x_res.dtype != torch.float32:
        raise ValueError(f"the gene kernel takes a float32 CUDA tensor, got {x_res.dtype} on {dev}")
    if gate and (row_thr.device != dev or row_thr.dtype != torch.float32):
        raise ValueError(f"row_thr must be float32 on {dev}, got {row_thr.dtype} on {row_thr.device}")
    x_res = x_res.contiguous()
    rows = x_res.shape[0]
    out = torch.empty((rows, gpd.total), dtype=torch.float32, device=dev)
    if rows == 0 or gpd.total == 0:
        return out
    thr = row_thr.contiguous() if gate else out  # not read when ungated
    lib = _build.library()
    with torch.cuda.device(dev):
        max_smem, g_lo, g_hi, g_counts, gidx, packed = _tables_on(gpd, dev)
        need = (2 * gpd.n_windows + gpd.n_groups) * 4
        if need > max_smem:
            raise ValueError(
                f"{gpd.n_windows} windows and {gpd.n_groups} coverage groups need {need} B of shared memory "
                f"per row; this card allows {max_smem}"
            )
        err = lib.gene_project_launch(
            x_res.data_ptr(), thr.data_ptr(), g_lo.data_ptr(), g_hi.data_ptr(), g_counts.data_ptr(),
            gidx.data_ptr(), None if packed is None else packed.data_ptr(), out.data_ptr(), rows, gpd.n_windows,
            gpd.n_groups, gpd.total, 0 if packed is None else packed.shape[1], int(gate), max_smem, THREADS,
            _build.current_stream(dev),
        )
    _build.check(err, "gene_project")
    gene_project_cuda.launches += 1
    return out


gene_project_cuda.launches = 0


def gene_project(
    x_res: torch.Tensor, row_thr: torch.Tensor | None, gpd: GeneProjectionData, *, gate: bool
) -> torch.Tensor:
    """Per-gene projection of the median-centred window matrix.

    A float32 CUDA tensor goes to the kernel; a CPU tensor, and float64 on any
    device, to the plain version; any other dtype raises.
    """
    if x_res.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"gene_project takes float32 or float64, got {x_res.dtype}")
    if x_res.is_cuda and x_res.dtype == torch.float32:
        return gene_project_cuda(x_res, row_thr, gpd, gate=gate)
    return gene_project_plain(x_res, row_thr, gpd, gate=gate)
