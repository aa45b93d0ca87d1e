"""Fused centre / clip / smooth / median (counterpart of ``infercnvpy_tpu/ops/pallas_fused.py``).

One pass per cell row computes:

1. bounded logFC centering against (ref_min, ref_max) — single-reference
   centering is ``x - ref``
2. clip to ±lfc_clip
3. the strided pyramid running window on the phase-major packed region, and
   the uniform means of small chromosomes, in final chromosome order
4. the exact per-row median over the windows and its subtraction
5. per-row sum / sum-of-squares of the median-centred windows (the inputs to
   the chunk-scoped noise gate, ``ops.infercnv_kernel.chunk_gate``)

:func:`fused_center_smooth_median` takes the CUDA kernel
(``csrc/fused_window.cu``, via :func:`fused_center_smooth_median_cuda`) for a
CUDA tensor and the plain PyTorch version
(:func:`fused_center_smooth_median_plain`) for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..genome.plan import WindowPlan
from . import _build
from .infercnv_kernel import center_smooth_median, packed_width, small_offsets

__all__ = [
    "fused_center_smooth_median", "fused_center_smooth_median_cuda", "fused_center_smooth_median_plain",
    "final_gather_map", "window_tasks", "tile_task_ranges", "pyramid_weights", "stage_plan", "staged_windows_emulated",
]


def _conv_region_windows(plan: WindowPlan) -> int:
    """Number of raw conv output positions P (stride-s coordinate)."""
    if not plan.n_reg_windows:
        return 0
    s = plan.step
    m = -(-plan.window_size // s)
    return plan.packed_len // s - m + 1


def final_gather_map(plan: WindowPlan) -> np.ndarray:
    """Map final window k -> column in the raw [conv | small] layout."""
    P = _conv_region_windows(plan)
    n_reg = plan.n_reg_windows
    src = plan.final_src
    out = np.empty(len(src), np.int32)
    reg = src < n_reg
    if n_reg:
        out[reg] = plan.conv_gather[src[reg]]
    out[~reg] = P + (src[~reg] - n_reg)
    return out


def _assembly_runs(plan: WindowPlan) -> list[tuple[int, int]]:
    """Maximal (src_start, length) runs of :func:`final_gather_map`.

    The map is piecewise consecutive (one run per chromosome; adjacent small
    chromosomes merge), which is why the kernel's tasks (:func:`window_tasks`)
    can take aligned groups of neighbouring conv positions.
    """
    gmap = final_gather_map(plan)
    runs: list[tuple[int, int]] = []
    i = 0
    while i < len(gmap):
        j = i + 1
        while j < len(gmap) and gmap[j] == gmap[j - 1] + 1:
            j += 1
        runs.append((int(gmap[i]), j - i))
        i = j
    return runs


#: conv positions per kernel task (``kGroup`` in ``csrc/fused_window.cu``)
GROUP = 4
#: floats the kernel may read past the last staged plane (its 16-byte look-ahead)
STAGE_PAD = 8


def window_tasks(plan: WindowPlan) -> np.ndarray:
    """(n_tasks, 4) int32 task table of the kernel, from :func:`final_gather_map`.

    A regular task ``(k_first, a4, j0 | j1 << 8, 0)`` is the aligned group of
    conv positions ``a4 .. a4 + 3`` (``a4 % 4 == 0``) of which ``j0 <= j < j1``
    are windows of one chromosome run: position ``a4 + j`` is final window
    ``k_first + j - j0``.  A small-chromosome task ``(k, col_a, -1, col_b)`` is
    the mean of packed columns ``[col_a, col_b)``.  Every final window belongs
    to exactly one task.  The regular tasks come first, sorted by ``a4`` (so a
    column tile's tasks are one slice, :func:`tile_task_ranges`), then the
    small-chromosome tasks.
    """
    gmap = final_gather_map(plan)
    P = _conv_region_windows(plan)
    off = small_offsets(plan)
    regular: list[tuple[int, int, int, int]] = []
    small: list[tuple[int, int, int, int]] = []
    k = 0
    n = len(gmap)
    while k < n:
        g = int(gmap[k])
        if g >= P:
            j = g - P
            small.append((k, int(off[j]), -1, int(off[j + 1])))
            k += 1
            continue
        a4 = g - g % GROUP
        e = k + 1
        while e < n and int(gmap[e]) == int(gmap[e - 1]) + 1 and int(gmap[e]) < min(a4 + GROUP, P):
            e += 1
        j0 = g - a4
        regular.append((k, a4, j0 | ((j0 + e - k) << 8), 0))
        k = e
    regular.sort(key=lambda t: (t[1], t[0]))
    return np.asarray(regular + small, dtype=np.int32).reshape(-1, 4)


def tile_task_ranges(tasks: np.ndarray, n_tiles: int, tile_conv: int) -> np.ndarray:
    """(n_tiles + 1,) int32: tile ``i`` owns the regular tasks ``tasks[ptr[i]:ptr[i + 1]]`` (``a4`` in its range)."""
    a4 = tasks[tasks[:, 2] >= 0, 1]
    return np.searchsorted(a4, np.arange(n_tiles + 1) * tile_conv, side="left").astype(np.int32)


def pyramid_weights(plan: WindowPlan) -> np.ndarray:
    """(window,) float32 unnormalised pyramid weights ``min(r + 1, window - r)``."""
    r = np.arange(plan.window_size)
    return np.minimum(r + 1, plan.window_size - r).astype(np.float32)


def stage_plan(plan: WindowPlan, shared_budget: int, max_smem: int) -> dict:
    """How a block of the kernel stages a packed row of ``plan`` in shared memory.

    The row goes through the conv positions in ``n_tiles`` column tiles of
    ``tile_conv`` (a multiple of 4).  A tile stages ``plane_stride =
    tile_conv + halo`` columns of each of the ``step`` phase planes, the halo
    covering the ``ceil(window / step) - 1`` taps that reach past the tile's
    last window and the kernel's 16-byte look-ahead, and with the first tile
    the small-chromosome tail at ``tail_off`` (``-1``: it does not fit and the
    kernel reads it from device memory).  Beside the stage, shared memory
    holds the row's windows and, for any window / step other than 100 / 10,
    the weight table.

    ``shared_budget`` is what a block may use if two blocks are to share an
    SM (one's loads then run under the other's arithmetic), ``max_smem`` the
    most a block can have.  If the whole packed row fits ``shared_budget``,
    or else ``max_smem``, it is staged as it is: one tile, the planes
    ``Q = packed_len / step`` apart, the tail right behind them.  A wider row
    takes the fewest tiles that fit ``shared_budget``, or if not even a
    4-position tile does, ``max_smem``.  Returns ``n_tiles, tile_conv, plane_stride,
    row_stage, tail_off, smem_bytes``; raises if nothing fits.
    """
    s, w = plan.step, plan.window_size
    P = _conv_region_windows(plan)
    tail = packed_width(plan) - plan.packed_len
    tail4 = tail + (-tail % 4)
    generic = (s, w) != (10, 100)
    fixed = plan.n_windows + (w if generic else 0)
    m = -(-w // s)
    halo = 4 * (-(-m // 4)) + 4
    whole = P + (-P % GROUP)  # one tile over all conv positions

    def whole_row(budget: int) -> dict | None:
        # the packed row as it is: planes Q apart, the tail right behind them
        for with_tail in (True, False):
            row_stage = plan.packed_len + (tail4 if with_tail else 0) + STAGE_PAD
            if (row_stage + fixed) * 4 <= budget and (P or with_tail or not tail):
                return dict(n_tiles=1, tile_conv=max(whole, GROUP), plane_stride=plan.packed_len // s,
                            row_stage=row_stage, tail_off=plan.packed_len if with_tail else -1,
                            smem_bytes=(row_stage + fixed) * 4)
        return None

    def tiles(budget: int) -> dict | None:
        if not P:
            return None
        for with_tail in (True, False):
            room = budget // 4 - fixed - STAGE_PAD - (tail4 if with_tail else 0)
            tile = (room // s) // 4 * 4 - halo
            if room < 0 or tile < GROUP:
                continue
            n_tiles = -(-P // tile)
            tile = -(-P // n_tiles)  # balance the tiles
            tile += -tile % GROUP
            planes = s * (tile + halo)
            row_stage = planes + (tail4 if with_tail else 0) + STAGE_PAD
            return dict(n_tiles=n_tiles, tile_conv=tile, plane_stride=tile + halo, row_stage=row_stage,
                        tail_off=planes if with_tail else -1, smem_bytes=(row_stage + fixed) * 4)
        return None

    shared_budget = min(shared_budget, max_smem)
    got = whole_row(shared_budget) or whole_row(max_smem) or tiles(shared_budget) or tiles(max_smem)
    if got is None and not P and (fixed + STAGE_PAD) * 4 <= max_smem:
        # small chromosomes only and a tail beyond shared memory: stage nothing
        return dict(n_tiles=1, tile_conv=GROUP, plane_stride=0, row_stage=STAGE_PAD, tail_off=-1,
                    smem_bytes=(fixed + STAGE_PAD) * 4)
    if got is None:
        raise ValueError(
            f"{plan.n_windows} windows with window {w} / step {s} leave no room for a row tile in "
            f"{max_smem} B of shared memory"
        )
    return got


def staged_windows_emulated(xc: np.ndarray, plan: WindowPlan, stage: dict) -> np.ndarray:
    """The kernel's window stage in numpy, with the kernel's indexing (f64 sums).

    ``xc`` is the centred, clipped packed matrix.  Walks the tiles and their
    task slices as ``csrc/fused_window.cu`` does: fills a stage buffer of
    ``row_stage`` per tile, reads every tap at the offset the kernel reads
    it, and raises ``IndexError`` if a tap of a kept window lies outside what
    the tile staged.  Returns the (rows, n_windows) windows before the median.
    """
    s, w = plan.step, plan.window_size
    Q = plan.packed_len // s
    tasks = window_tasks(plan)
    n_small = int((tasks[:, 2] < 0).sum()) if len(tasks) else 0
    ptr = tile_task_ranges(tasks, stage["n_tiles"], stage["tile_conv"])
    wts = pyramid_weights(plan).astype(np.float64)
    rows = xc.shape[0]
    win = np.full((rows, plan.n_windows), np.nan)
    ps, tail_off = stage["plane_stride"], stage["tail_off"]
    for tile in range(stage["n_tiles"]):
        c0 = tile * stage["tile_conv"]
        buf = np.full((rows, stage["row_stage"]), np.nan)
        ln = min(ps, Q - c0)
        for t in range(s):
            buf[:, t * ps : t * ps + ln] = xc[:, t * Q + c0 : t * Q + c0 + ln]
        if tile == 0 and tail_off >= 0:
            buf[:, tail_off : tail_off + xc.shape[1] - plan.packed_len] = xc[:, plan.packed_len :]
        for k_first, a4, z, _ in tasks[ptr[tile] : ptr[tile + 1]]:
            if not c0 <= a4 < c0 + stage["tile_conv"]:
                raise IndexError(f"task at conv position {a4} is not in tile {tile}")
            j0, j1 = z & 0xFF, z >> 8
            for j in range(j0, j1):
                acc = np.zeros(rows)
                for t in range(s):
                    for u in range(-(-(w - t) // s)):
                        at = t * ps + (a4 - c0) + u + j
                        if at >= stage["row_stage"]:
                            raise IndexError(f"tap at {at} beyond the stage of {stage['row_stage']} floats")
                        acc += wts[u * s + t] * buf[:, at]
                win[:, k_first + j - j0] = acc / plan.pyramid_sum
        if tile == 0:
            for k, col_a, _, col_b in tasks[len(tasks) - n_small :]:
                if tail_off >= 0:
                    vals = buf[:, tail_off + col_a - plan.packed_len : tail_off + col_b - plan.packed_len]
                else:
                    vals = xc[:, col_a:col_b]
                win[:, k] = vals.astype(np.float64).sum(1) / (col_b - col_a)
    return win


def _check_inputs(x: torch.Tensor, ref_min_max: torch.Tensor, plan: WindowPlan, n_ref: int) -> None:
    width = packed_width(plan)
    if x.dim() != 2 or x.shape[1] != width:
        raise ValueError(f"x must be (cells, {width}), got {tuple(x.shape)}")
    if tuple(ref_min_max.shape) != (2, width):
        raise ValueError(f"ref_min_max must be (2, {width}), got {tuple(ref_min_max.shape)}")
    if n_ref not in (1, 2):
        raise ValueError(f"n_ref must be 1 or 2, got {n_ref}")


def fused_center_smooth_median_plain(
    x: torch.Tensor, ref_min_max: torch.Tensor, plan: WindowPlan, *, lfc_clip: float, n_ref: int = 2
):
    """Plain PyTorch version of the fused kernel (any device, f32 or f64)."""
    _check_inputs(x, ref_min_max, plan, n_ref)
    ref = ref_min_max[:1] if n_ref == 1 else ref_min_max
    x_res, med = center_smooth_median(x, ref, plan, lfc_clip)
    return x_res, x_res.sum(dim=1), (x_res * x_res).sum(dim=1), med


#: (plan.cache_key, device, smem_limit) -> (stage plan, max_smem, tasks, tile_ptr, wtab), the tables on
#: the device.  Keyed by the plan's content digest; ``tl.clear_transform_caches`` empties it.
_device_tables: dict[tuple, tuple] = {}

#: threads of a fused_window block (a multiple of 32, at most 512)
THREADS = 512


def _launch_plan(plan: WindowPlan, dev: torch.device, smem_limit: int | None):
    """The stage plan for ``dev`` and the plan's tables on it, made and uploaded once per (plan, device, limit)."""
    key = (plan.cache_key, str(dev), smem_limit)
    hit = _device_tables.get(key)
    if hit is None:
        lib = _build.library()
        max_smem = lib.fused_window_smem_budget(1)
        shared = lib.fused_window_smem_budget(2)
        if max_smem < 0 or shared < 0:
            _build.check(-min(max_smem, shared), "fused_window")
        limit = max_smem if smem_limit is None else min(max_smem, int(smem_limit))
        stage = stage_plan(plan, min(shared, limit), limit)
        tasks = window_tasks(plan)
        arrays = (tasks, tile_task_ranges(tasks, stage["n_tiles"], stage["tile_conv"]), pyramid_weights(plan))
        hit = (stage, max_smem, *(torch.from_numpy(a).to(dev) for a in arrays))
        # later launches may run on other streams than the one that copied
        torch.cuda.current_stream(dev).synchronize()
        _device_tables[key] = hit
    return hit


def fused_center_smooth_median_cuda(
    x: torch.Tensor, ref_min_max: torch.Tensor, plan: WindowPlan, *, lfc_clip: float, n_ref: int = 2,
    smem_limit: int | None = None,
):
    """Launch ``csrc/fused_window.cu`` (float32 CUDA tensors only); raises on any failure.

    ``smem_limit`` caps the shared memory the stage plan may use (bytes), to
    drive narrow column tiles at a small shape; ``None`` takes the card's.
    """
    _check_inputs(x, ref_min_max, plan, n_ref)
    dev = x.device
    if not (x.is_cuda and ref_min_max.device == dev):
        raise ValueError(f"x and ref_min_max must be on one CUDA device, got {x.device} and {ref_min_max.device}")
    if x.dtype != torch.float32 or ref_min_max.dtype != torch.float32:
        raise ValueError(f"the fused kernel takes float32, got {x.dtype} and {ref_min_max.dtype}")
    x = x.contiguous()
    ref_min_max = ref_min_max.contiguous()
    rows = x.shape[0]
    n_windows = plan.n_windows
    out = torch.empty((rows, n_windows), dtype=torch.float32, device=dev)
    stats = torch.empty((rows, 3), dtype=torch.float32, device=dev)
    if rows == 0:
        return out, stats[:, 0], stats[:, 1], stats[:, 2]
    lib = _build.library()
    with torch.cuda.device(dev):
        stage, max_smem, tasks, tile_ptr, wtab = _launch_plan(plan, dev, smem_limit)
        s = plan.step
        err = lib.fused_window_launch(
            x.data_ptr(), ref_min_max.data_ptr(), tasks.data_ptr(), tile_ptr.data_ptr(), wtab.data_ptr(),
            out.data_ptr(), stats.data_ptr(), rows, x.shape[1], n_windows, tasks.shape[0],
            n_windows - plan.n_reg_windows, plan.packed_len, plan.packed_len // s, s, plan.window_size,
            int(n_ref == 1), stage["n_tiles"], stage["tile_conv"], stage["plane_stride"], stage["row_stage"],
            stage["tail_off"], stage["smem_bytes"], max_smem, THREADS, float(lfc_clip), float(np.float32(1.0 / plan.pyramid_sum)), _build.current_stream(dev),
        )
    _build.check(err, "fused_window")
    fused_center_smooth_median_cuda.launches += 1
    return out, stats[:, 0], stats[:, 1], stats[:, 2]


fused_center_smooth_median_cuda.launches = 0


def fused_center_smooth_median(
    x: torch.Tensor, ref_min_max: torch.Tensor, plan: WindowPlan, *, lfc_clip: float, n_ref: int = 2
):
    """Run the fused centre / clip / smooth / median step.

    x            — (cells, packed_width) phase-major packed expression
    ref_min_max  — (2, packed_width): per-gene min / max of the reference
                   category means (equal rows for a single reference)
    n_ref        — 1 selects single-baseline centering (``x - ref_min_max[0]``),
                   2 the bounded logFC
    Returns ``(x_res_final_order, row_sum, row_sumsq, med)``: the window matrix
    in final chromosome order, median-centred, before the noise gate.

    A CUDA tensor goes to the kernel (float32 only; anything else raises), a
    CPU tensor to the plain version.
    """
    if x.is_cuda:
        return fused_center_smooth_median_cuda(x, ref_min_max, plan, lfc_clip=lfc_clip, n_ref=n_ref)
    return fused_center_smooth_median_plain(x, ref_min_max, plan, lfc_clip=lfc_clip, n_ref=n_ref)
