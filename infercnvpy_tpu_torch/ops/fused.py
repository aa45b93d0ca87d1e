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
    "final_gather_map",
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
    chromosomes merge), which is why consecutive threads of the kernel read
    consecutive columns.
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


def fused_center_smooth_median_cuda(
    x: torch.Tensor, ref_min_max: torch.Tensor, plan: WindowPlan, *, lfc_clip: float, n_ref: int = 2
):
    """Launch ``csrc/fused_window.cu`` (float32 CUDA tensors only); raises on any failure."""
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
        max_smem = lib.fused_window_max_smem()
        if max_smem < 0:
            _build.check(-max_smem, "fused_window")
        if n_windows * 4 > max_smem:
            raise ValueError(
                f"{n_windows} windows need {n_windows * 4} B of shared memory per row; this card allows {max_smem}"
            )
        gmap = torch.as_tensor(final_gather_map(plan), device=dev)
        small_off = torch.as_tensor(small_offsets(plan), device=dev)
        s = plan.step
        err = lib.fused_window_launch(
            x.data_ptr(), ref_min_max.data_ptr(), gmap.data_ptr(), small_off.data_ptr(), out.data_ptr(),
            stats.data_ptr(), rows, x.shape[1], n_windows, _conv_region_windows(plan), plan.packed_len // s, s,
            plan.window_size, int(n_ref == 1), float(lfc_clip), float(np.float32(1.0 / plan.pyramid_sum)),
            _build.current_stream(dev),
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
