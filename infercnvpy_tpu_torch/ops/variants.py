"""Where a kernel's time goes: time copies of the sources with parts taken out.

    python -m infercnvpy_tpu_torch.ops.variants [variant ...]

The card's machine may have no profiler that reads a kernel's stalls, so this
script answers "what does this part cost" by removal: it copies ``csrc/`` to a
temporary directory, replaces one statement of a kernel by a cheap stand-in
(the median by the first window, the window sums by a copy, the reference
loads by arithmetic on the value, the expansion's stores by nothing), builds
the copy, and times it at 16,384 rows of the benchmark genome beside the
unchanged sources.  The variants' results are wrong on purpose and are never
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
    keep = _build._LIB
    try:
        for name in names:
            with tempfile.TemporaryDirectory() as td:
                _build._LIB = build_variant(VARIANTS[name], Path(td))
                res = {"variant": name, "rows": ROWS}
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
