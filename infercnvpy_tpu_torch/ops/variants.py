"""Where a kernel's time goes: time copies of the sources with parts taken out.

    python -m infercnvpy_tpu_torch.ops.variants [variant ...]

The card's machine may have no profiler that reads a kernel's stalls, so this
script answers "what does this part cost" by removal: it copies ``csrc/`` to a
temporary directory, replaces one statement of a kernel by a cheap stand-in
(the median by the first window, the window sums by a copy, the reference
loads by arithmetic on the value, the expansion's stores by nothing, the
warp select's later passes or the whole select by nothing, the warps a
block of the warp select by another count, parts of the weighted warp
select), builds the copy,
and times it at 16,384 rows of the benchmark genome beside the unchanged
sources (``warp_*`` variants: K2 at 1,793 and 1,794 columns, K5 at 1,793;
``wsel_*`` variants: K4's warp kernel at the plan's 1,991 groups with its
weights, all 10, and with seeded uneven weights 0-64, ~10 % zeros, each with
an even and an odd total).  The variants' results are wrong on purpose and are never
checked; only their times are read.  Prints one JSON line per variant; needs a
CUDA device.  A stand-in that no longer matches its source line raises, so an
edited kernel cannot be timed under an old name.
"""

from __future__ import annotations

import ctypes
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROWS = 16_384
_CENTRE = "centre4(v, __ldg(lo4 + i), __ldg(hi4 + i), a.single_ref, a.lfc_clip)"
_HALF = "make_float4(v.x * 0.5f + 1.f, v.y * 0.5f + 1.f, v.z * 0.5f + 1.f, v.w * 0.5f + 1.f)"
_K1_NO_SELECT = [("const float med = block_median(win, a.n_windows, hist);", "const float med = win[0];")]
_K1_NO_WINDOWS = [(
    "window_group<kStep, kWindow>(stage + (task.y - c0), a.plane_stride, a.step, a.window, wtab, acc);",
    "for (int j = 0; j < kGroup; ++j) acc[j] = stage[task.y - c0 + j];",
)]
_K1_NO_REF = [(_CENTRE, f"centre4(v, make_float4(v.x * 0.5f, v.y * 0.5f, v.z * 0.5f, v.w * 0.5f), {_HALF}, "
               "a.single_ref, a.lfc_clip)")]
_K1_NO_OUT = [("orow[k] = d;", "if (d == 12345.f) orow[k] = d;")]
#: variant -> {source file: [(statement, stand-in), ...]}
VARIANTS = {
    "base": {},
    "k1_no_select": {"fused_window.cu": _K1_NO_SELECT},
    "k1_no_windows": {"fused_window.cu": _K1_NO_WINDOWS},
    "k1_half_ref": {"fused_window.cu": [(_CENTRE, f"centre4(v, __ldg(lo4 + i), {_HALF}, a.single_ref, a.lfc_clip)")]},
    "k1_stage_only": {"fused_window.cu": _K1_NO_SELECT + _K1_NO_WINDOWS},
    "k1_stage_only_no_ref": {"fused_window.cu": _K1_NO_SELECT + _K1_NO_WINDOWS + _K1_NO_REF},
    "k1_stage_only_no_ref_no_out": {"fused_window.cu": _K1_NO_SELECT + _K1_NO_WINDOWS + _K1_NO_REF + _K1_NO_OUT},
    "k3_no_select": {"gene_project.cu": [(
        "const float med = block_weighted_median<true>(u, g_counts, n_groups, n_covered, hist);",
        "const float med = u[0];",
    )]},
    "k3_no_means": {"gene_project.cu": [("for (int j = lo; j <= hi; ++j) s += win[j];", "s = win[lo];")]},
    "k3_no_expand": {"gene_project.cu": [("for (int i = tid; i < n4; i += threads) {",
                                          "for (int i = tid; i < (n4 >> 10); i += threads) {")]},
    "k3_plain_store": {"gene_project.cu": [("__stcs(o4 + i, v);", "o4[i] = v;")]},
    "warp_base": {},
    # what the first pass's atomics cost: plain stores in their place
    "warp_pass1_stores": {"warp_select.cuh": [(
        "if (j < mine) atomicAdd(copy + (keys[j] >> (32 - kRadixBits)), 1);",
        "if (j < mine) copy[keys[j] >> (32 - kRadixBits)] = 1;")]},
    # an even width without the upper middle's step (the lower middle twice)
    "warp_no_upper_step": {"warp_select.cuh": [(
        "*key_hi = at_most > rank_lo + 1 ? pre : above_min;", "*key_hi = pre;")]},
    # 2 or 8 copies of the first pass's histogram (16 or 4 lanes a copy) instead of 4
    "warp_2_copies": {"warp_select.cuh": [("constexpr int kCopies = 4;", "constexpr int kCopies = 2;")]},
    "warp_8_copies": {"warp_select.cuh": [("constexpr int kCopies = 4;", "constexpr int kCopies = 8;")]},
    # only the loads: the keys' exclusive or stands in for the select
    "warp_loads_only": {"warp_select.cuh": [(
        "warp_select2<kKeys, kTwo>(keys, width, k, scratch, &lo, &hi);",
        "lo = 0; for (int j = 0; j < kKeys; ++j) lo ^= keys[j]; hi = lo;")]},
    # other warps a block than the 4 of the source (12 is the most an SM's shared memory holds)
    **{f"warp_{n}_warps": {"warp_select.cuh": [("constexpr int kWarpsPerBlock = 4;",
                                                 f"constexpr int kWarpsPerBlock = {n};")]} for n in (1, 2, 8, 12)},
    "wsel_base": {},
    # the first pass adds 1 in place of each slot's weight (increments the hardware merges): what the turns of
    # the lanes that meet on a bin cost
    "wsel_pass1_ones": {"warp_select.cuh": [(
        "if (w[i] > 0) atomicAdd(copy + (keys[j0 + i] >> (32 - kRadixBits)), w[i]);",
        "if (w[i] > 0) atomicAdd(copy + (keys[j0 + i] >> (32 - kRadixBits)), 1);")]},
    # the 32-bit weight table (8 KB a block, 3 blocks an SM) at every total
    "wsel_32bit_table": {"row_select.cu": [("wide = total > 0xFFFF;", "wide = true;")]},
    # K2 / K5's scratch a warp (a list of 1,024 pairs): 12 warps an SM in place of 16
    "wsel_12_warps": {"warp_select.cuh": [("constexpr int kWScratch = kCopies * kCopyStride;",
                                           "constexpr int kWScratch = kWarpScratch;")]},
    # every list through passes 2-4: no one-step rank of a list of at most 32 keys
    "wsel_no_short_list": {"warp_select.cuh": [("  if (count <= 32) {", "  if (count <= 0) {")]},
    # no list: passes 2-4 and the upper middle over the row read again, as for a list that overflows
    "wsel_no_list": {"warp_select.cuh": [
        ("  if (count <= 32) {", "  if (count <= 0) {"),
        ("const bool listed = count <= kListPairs;", "const bool listed = false;"),
        ("if (keep && at < kListPairs) {", "if (keep && at < 0) {")]},
    # the first pass and the list only: rank_lo's top digit, its lower 24 bits zero
    "wsel_no_later_passes": {"warp_select.cuh": [
        ("  if (count <= 32) {", "  if (count <= 0) {"),
        ("for (int pass = 1; pass < kPasses; ++pass) {", "for (int pass = 1; pass < 1; ++pass) {")]},
    # only the loads: the keys' exclusive or stands in for the weighted select
    "wsel_loads_only": {"warp_select.cuh": [(
        "warp_wselect2<kKeys, kTwo, W>(keys, wt, rank_lo, row, width, scratch, &lo, &hi);",
        "lo = 0; for (int j = 0; j < kKeys; ++j) lo ^= keys[j]; hi = lo;")]},
}


def build_variant(edits: dict, out: Path) -> ctypes.CDLL:
    """Copy ``csrc/`` into ``out`` with ``edits`` applied, build it, and load it with the library's signatures."""
    from . import _build

    src = out / "src"
    src.mkdir()
    for f in _build.CSRC.iterdir():
        text = f.read_text()
        for old, new in edits.get(f.name, []):
            if old not in text:
                raise ValueError(f"{f.name} no longer holds the statement {old!r}")
            text = text.replace(old, new)
        (src / f.name).write_text(text)
    _build.compile_sources(sorted(src.glob("*.cu")), out / "lib.so")
    return _build.bind(ctypes.CDLL(str(out / "lib.so")))


def _k4_times(lib, gpd, x, out) -> dict:
    """K4's warp kernel through its C entry point: ms by weights (bench / uneven, the same for every variant) and
    total (even / odd)."""
    import torch

    from . import _build
    from .compare import cuda_ms, k4_weight_cases

    res = {}
    stream = _build.current_stream(x.device)
    for name, width, base in k4_weight_cases(gpd, np.random.default_rng(7))[:2]:
        for parity in ("even", "odd"):
            wts = base.astype(np.int32)
            wts[np.flatnonzero(wts)[0]] += (int(wts.sum()) + (parity == "odd")) % 2
            wd = torch.from_numpy(wts).to(x.device)
            total = int(wts.sum())
            res[f"row_median_weighted_{name}_{parity}_ms"] = cuda_ms(lambda: lib.row_median_weighted_warp_launch(
                x.data_ptr(), wd.data_ptr(), out.data_ptr(), ROWS, width, total, stream), 20)
    return res


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("variants: torch.cuda.is_available() is False — this script needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # chip_smoke's generators
    import chip_smoke as cs

    from ..genome import build_window_plan
    from . import _build, fused, gene
    from .compare import cuda_ms
    from .infercnv_kernel import packed_width

    names = list(argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    dev = torch.device("cuda")
    plan = build_window_plan(cs.make_var(cs.N_GENES), 100, 10)
    gpd = gene.gene_projection_data(plan)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((ROWS, packed_width(plan)), dtype=np.float32)).to(dev)
    ref = rng.standard_normal((2, packed_width(plan)), dtype=np.float32)
    ref2 = torch.from_numpy(np.stack([ref.min(0), ref.max(0)])).to(dev)
    xw = torch.from_numpy(rng.standard_normal((ROWS, plan.n_windows), dtype=np.float32)).to(dev)
    thr = torch.from_numpy(rng.uniform(0, 1, ROWS).astype(np.float32)).to(dev)
    out = torch.empty((ROWS,), dtype=torch.float32, device=dev)
    xe = torch.from_numpy(rng.standard_normal((ROWS, plan.n_windows + 1), dtype=np.float32)).to(dev)
    xg = torch.from_numpy(rng.standard_normal((ROWS, gpd.n_groups), dtype=np.float32)).to(dev)
    keep = _build._LIB
    try:
        for name in names:
            with tempfile.TemporaryDirectory() as td:
                _build._LIB = build_variant(VARIANTS[name], Path(td))
                res = {"variant": name, "rows": ROWS}
                if name.startswith("wsel"):
                    res.update(_k4_times(_build._LIB, gpd, xg, out))
                    print(json.dumps(res), flush=True)
                    continue
                if name.startswith("warp"):
                    # through the C entry points: the kernel's time, not the wrapper's
                    lib, stream, w = _build._LIB, _build.current_stream(dev), plan.n_windows
                    res["row_median_ms"] = cuda_ms(lambda: lib.row_median_warp_launch(
                        xw.data_ptr(), out.data_ptr(), ROWS, w, stream), 20)
                    res["row_median_even_ms"] = cuda_ms(lambda: lib.row_median_warp_launch(
                        xe.data_ptr(), out.data_ptr(), ROWS, w + 1, stream), 20)
                    res["row_kth_smallest_ms"] = cuda_ms(lambda: lib.row_kth_smallest_warp_launch(
                        xw.data_ptr(), out.data_ptr(), ROWS, w, w // 2, stream), 20)
                    print(json.dumps(res), flush=True)
                    continue
                if not name.startswith("k3"):
                    res["fused_window_ms"] = cuda_ms(
                        lambda: fused.fused_center_smooth_median_cuda(x, ref2, plan, lfc_clip=3.0), 20)
                if not name.startswith("k1"):
                    res["gene_project_ms"] = cuda_ms(lambda: gene.gene_project_cuda(xw, thr, gpd, gate=True), 20)
                print(json.dumps(res), flush=True)
    finally:
        _build._LIB = keep
    return 0


if __name__ == "__main__":
    sys.exit(main())
