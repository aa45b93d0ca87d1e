"""Time this tree's kernels against another checkout's, in turns, on one card.

    python -m infercnvpy_tpu_torch.ops.compare [--parent DIR] [--sweep]

``DIR`` is the root of another checkout of the repository whose kernels have
the C interface of :data:`PARENT_SIGNATURES` (commit 1453ff3's: K1, K3, K6
and the K2 / K5 warp and block kernels as in this tree, the weighted median
K4 one block a row at every width), e.g.

    mkdir parent_tree && git archive 1453ff3 | tar -x -C parent_tree

Its ``csrc/`` is built into a second library in a temporary directory.  K1
and K3, whose interface this tree keeps, run through this tree's wrappers
with the parent's library in place of this tree's; K2, K4 and K5 are
launched through ctypes with the parent's arguments.  At 16,384 rows of the
benchmark genome (20,000 genes, window 100, step 10) each kernel is timed in
the order parent, this tree, this tree, parent (CUDA events around ``--reps``
launches in a row, median of 5 such runs after a warm-up): K1; K3 gated; K2
at 1,793 and 1,794 columns and K5 at 1,793 columns, k = 0, 896 and 1,792
(warp kernel against warp kernel); K4 kernel against kernel at the plan's
1,991 groups with its weights (all 10) and with seeded uneven weights (0-64,
~10 % zeros), each with an even and an odd total, and with those weights
doubled (a total past 16 bits: the 32-bit weight table) (this tree's warp
kernel against the parent's block kernel), and at 20,000 columns (block
against block).  This
tree's result is held against the parent's (K2, K4, K5 and ungated K3 bit
for bit; K1 at rtol 1e-5 / atol 1e-6).  K4's wrapper is also timed in turns
at 1,991 groups: the parent's ``ops/select.py`` (loaded from ``DIR``,
launching the parent's library) against this tree's, with the weights on the
device and on the host.

``--sweep`` times this tree's block select kernels (K4, and K2 / K5 at 1,793
columns) at 32 to 1,024 threads a block through their C entry points, then K3
and K1 through their wrappers (the warp kernels' warps a block are a
constant of their source: ``ops/variants.py``'s ``warp_*_warps`` time other
counts).  Prints one JSON line per measurement; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROWS = 16_384
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the C interface of ``ops/_build.py`` at commit 1453ff3
PARENT_SIGNATURES = {
    "fused_window_launch": (_P, _P, _P, _P, _P, _P, _P, *([_I] * 18), _F, _F, _P),
    # x, out, rows, width, threads, stream
    "row_median_launch": (_P, _P, _I, _I, _I, _P),
    # x, out, rows, width, stream
    "row_median_warp_launch": (_P, _P, _I, _I, _P),
    "fused_window_smem_budget": (_I,),
    # x, wts, out, rows, width, total, threads, stream
    "row_median_weighted_launch": (_P, _P, _P, _I, _I, _I, _I, _P),
    # x, out, rows, width, k, threads, stream
    "row_kth_smallest_launch": (_P, _P, _I, _I, _I, _I, _P),
    # x, out, rows, width, k, stream
    "row_kth_smallest_warp_launch": (_P, _P, _I, _I, _I, _P),
    "gene_project_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "gene_project_max_smem": (),
    "write_probe_launch": (_P, _P, _I, _I, _I, _I, _P),
}
PARENT_THREADS = 256  #: the parent's ``ops/select.py::THREADS``

def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def build_parent(parent: Path, out_dir: Path) -> ctypes.CDLL:
    """Compile ``parent``'s ``csrc/*.cu`` into ``out_dir`` and load it with :data:`PARENT_SIGNATURES`."""
    from . import _build

    lib_path = out_dir / "libparent.so"
    _build.compile_sources(sorted((parent / "infercnvpy_tpu_torch" / "csrc").glob("*.cu")), lib_path)
    return _build.bind(ctypes.CDLL(str(lib_path)), PARENT_SIGNATURES)


def cuda_ms(fn, reps: int, rounds: int = 5) -> float:
    """Time of one ``fn()`` in ms: ``chip_smoke.cuda_ms`` (CUDA events around ``reps`` launches queued behind a
    spin of the stream, median of ``rounds`` such runs), so both scripts time a kernel alike."""
    import chip_smoke as cs

    return cs.cuda_ms(fn, reps=rounds, inner=reps)


def _turns(name: str, parent_fn, change_fn, reps: int, **extra) -> None:
    order = [("parent", parent_fn), ("change", change_fn), ("change", change_fn), ("parent", parent_fn)]
    ms = {"parent": [], "change": []}
    for who, fn in order:
        ms[who].append(cuda_ms(fn, reps))
    _emit(kernel=name, rows=ROWS, parent_ms=ms["parent"], change_ms=ms["change"],
          speedup=float(np.mean(ms["parent"]) / np.mean(ms["change"])), **extra)


def _wrapper_times(fn, reps: int) -> dict:
    """A wrapper's CUDA-event time and the host's time to enqueue one call (no wait in between), in ms."""
    import time

    import torch

    ms = cuda_ms(fn, reps)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    return {"wrapper_ms": ms, "wrapper_enqueue_ms": enqueue}


def _checked(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


class _ParentLibrary:
    """Within ``with``: this tree's wrappers launch the parent's library (for kernels whose interface is unchanged)."""

    def __init__(self, plib):
        self.plib = plib

    def __enter__(self):
        from . import _build

        self.keep = _build._LIB
        _build._LIB = self.plib

    def __exit__(self, *exc):
        from . import _build

        _build._LIB = self.keep


def parent_select(parent: Path):
    """The parent's ``ops/select.py`` as a module beside this tree's: its ``from . import _build`` is this tree's,
    so within :class:`_ParentLibrary` its wrappers launch the parent's library."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "infercnvpy_tpu_torch.ops._parent_select", parent / "infercnvpy_tpu_torch" / "ops" / "select.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def compare_kernels(plib: ctypes.CDLL, psel, reps: int) -> None:
    import torch

    import chip_smoke as cs

    from ..genome import build_window_plan
    from . import fused, gene, select
    from ._build import current_stream, library
    from .infercnv_kernel import packed_width

    dev = torch.device("cuda")
    plan = build_window_plan(cs.make_var(cs.N_GENES), 100, 10)
    rng = np.random.default_rng(0)
    width = packed_width(plan)
    stream = lambda: current_stream(dev)  # noqa: E731
    parent = _ParentLibrary(plib)

    def same(got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{what}: this tree's result differs from the parent's")

    # K1
    x = torch.from_numpy(rng.standard_normal((ROWS, width), dtype=np.float32)).to(dev)
    ref = rng.standard_normal((2, width), dtype=np.float32)
    ref2 = torch.from_numpy(np.stack([ref.min(0), ref.max(0)])).to(dev)

    def k1():
        return fused.fused_center_smooth_median_cuda(x, ref2, plan, lfc_clip=3.0, n_ref=2)

    def k1_parent():
        with parent:
            return k1()

    want = k1_parent()
    got = k1()
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-6)
    _turns("fused_window", k1_parent, k1, reps, max_abs_diff=float((got[0] - want[0]).abs().max()))
    del x, got, want

    # K3
    gpd = gene.gene_projection_data(plan)
    xw = torch.from_numpy(rng.standard_normal((ROWS, plan.n_windows), dtype=np.float32)).to(dev)
    thr = torch.from_numpy(rng.uniform(0.0, 1.0, ROWS).astype(np.float32)).to(dev)

    def k3(gate=True):
        return gene.gene_project_cuda(xw, thr, gpd, gate=gate)

    def k3_parent(gate=True):
        with parent:
            return k3(gate)

    for gate in (False, True):
        want = k3_parent(gate)
        got = k3(gate)
        torch.cuda.synchronize()
        if not gate:
            same(got, want, "K3 ungated")
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        del got, want
    _turns("gene_project", k3_parent, k3, reps)
    del xw

    # K2 at 1,793 and 1,794, K5 at 1,793: warp kernel against warp kernel through the C entry points, then
    # this tree's wrapper (CUDA events, and the host's time to enqueue a call)
    lib = library()
    m_out = torch.empty((ROWS,), dtype=torch.float32, device=dev)
    c_out = torch.empty_like(m_out)
    for w in (plan.n_windows, plan.n_windows + 1):
        xm = torch.from_numpy(rng.standard_normal((ROWS, w), dtype=np.float32)).to(dev)

        def k2_parent():
            _checked(plib.row_median_warp_launch(xm.data_ptr(), m_out.data_ptr(), ROWS, w, stream()), "parent K2")

        def k2_change():
            _checked(lib.row_median_warp_launch(xm.data_ptr(), c_out.data_ptr(), ROWS, w, stream()), "K2")

        k2_parent()
        k2_change()
        same(c_out, m_out, f"K2 at {w}")
        same(select.row_median_cuda(xm), m_out, f"K2 wrapper at {w}")
        _turns("row_median", k2_parent, k2_change, reps, width=w, variant=select.select_variant(w),
               **_wrapper_times(lambda: select.row_median_cuda(xm), reps))

    w = plan.n_windows
    xm = torch.from_numpy(rng.standard_normal((ROWS, w), dtype=np.float32)).to(dev)
    for k in (0, w // 2, w - 1):
        def k5_parent():
            _checked(plib.row_kth_smallest_warp_launch(xm.data_ptr(), m_out.data_ptr(), ROWS, w, k, stream()),
                     "parent K5")

        def k5_change():
            _checked(lib.row_kth_smallest_warp_launch(xm.data_ptr(), c_out.data_ptr(), ROWS, w, k, stream()), "K5")

        k5_parent()
        k5_change()
        same(c_out, m_out, f"K5 k={k}")
        same(select.row_kth_smallest_cuda(xm, k), m_out, f"K5 wrapper k={k}")
        _turns("row_kth_smallest", k5_parent, k5_change, reps, width=w, k=k, variant=select.select_variant(w),
               **_wrapper_times(lambda: select.row_kth_smallest_cuda(xm, k), reps))
    del xm

    # K4: the parent's block kernel against this tree's kernel of the width's variant, then the wrappers
    for name, width, base in k4_weight_cases(gpd, rng):
        xg = torch.from_numpy(rng.standard_normal((ROWS, width), dtype=np.float32)).to(dev)
        for parity in ("even", "odd") if name in ("bench", "uneven") and width == gpd.n_groups else ("even",):
            wts_host = base.astype(np.int32)
            wts_host[np.flatnonzero(wts_host)[0]] += (int(wts_host.sum()) + (parity == "odd")) % 2
            wts = torch.from_numpy(wts_host).to(dev)
            total = int(wts_host.sum())
            variant = select.select_variant(width)

            def k4_parent():
                _checked(plib.row_median_weighted_launch(xg.data_ptr(), wts.data_ptr(), m_out.data_ptr(), ROWS,
                                                         width, total, PARENT_THREADS, stream()), "parent K4")

            def k4_change():
                if variant == "warp":
                    err = lib.row_median_weighted_warp_launch(xg.data_ptr(), wts.data_ptr(), c_out.data_ptr(), ROWS,
                                                              width, total, stream())
                else:
                    err = lib.row_median_weighted_launch(xg.data_ptr(), wts.data_ptr(), c_out.data_ptr(), ROWS,
                                                         width, total, select.THREADS, stream())
                _checked(err, "K4")

            k4_parent()
            k4_change()
            same(c_out, m_out, f"K4 {name} {parity}")
            same(select.row_median_weighted_cuda(xg, wts_host), m_out, f"K4 wrapper {name} {parity}")
            same(select.row_median_weighted_cuda(xg, wts), m_out, f"K4 wrapper {name} {parity}, weights on the device")
            bits = 16 if variant == "warp" and total <= select.WARP_NARROW_TOTAL else 32
            case = dict(width=width, weights=name, total=total, variant=variant, weight_bits=bits)
            _turns("row_median_weighted", k4_parent, k4_change, reps, **case)
            if variant != "warp" or bits != 16:
                continue
            for where, weights in (("device", wts), ("host", wts_host)):
                def k4_parent_wrapper():
                    with parent:
                        return psel.row_median_weighted_cuda(xg, weights)

                same(k4_parent_wrapper(), m_out, f"parent K4 wrapper, weights on the {where}")
                _turns("row_median_weighted_wrapper", k4_parent_wrapper,
                       lambda: select.row_median_weighted_cuda(xg, weights), reps, **case, weights_on=where)
        del xg


def k4_weight_cases(gpd, rng) -> list:
    """K4's timed inputs: ``(name, width, weights)``: the bench plan's genes per group (all 10) and seeded uneven
    weights 0-64 with ~10 % zeros at its 1,991 groups (totals within 16 bits), those uneven weights doubled (a
    total past 16 bits: the warp kernel's 32-bit weight table), and uneven weights at 20,000 columns (the block
    variant)."""
    cases = [("bench", gpd.n_groups, np.asarray(gpd.g_counts, np.int64))]
    for width in (gpd.n_groups, 20_000):
        uneven = rng.integers(1, 65, size=width)
        uneven[rng.random(width) < 0.1] = 0
        cases.append(("uneven", width, uneven))
    cases.insert(2, ("uneven_doubled", gpd.n_groups, 2 * cases[1][2]))
    return cases


def sweep(reps: int) -> None:
    """This tree's kernels at other block sizes."""
    import torch

    import chip_smoke as cs

    from ..genome import build_window_plan
    from . import fused, gene
    from ._build import current_stream, library
    from .infercnv_kernel import packed_width

    dev = torch.device("cuda")
    plan = build_window_plan(cs.make_var(cs.N_GENES), 100, 10)
    gpd = gene.gene_projection_data(plan)
    rng = np.random.default_rng(1)
    w = plan.n_windows
    xm = torch.from_numpy(rng.standard_normal((ROWS, w), dtype=np.float32)).to(dev)
    xg = torch.from_numpy(rng.standard_normal((ROWS, gpd.n_groups), dtype=np.float32)).to(dev)
    wts = torch.from_numpy(gpd.g_counts.astype(np.int32)).to(dev)
    out = torch.empty((ROWS,), dtype=torch.float32, device=dev)
    lib = library()
    stream = current_stream(dev)
    for threads in (32, 64, 128, 256, 512, 1024):
        _emit(sweep="block_selects", threads=threads, width=w,
              row_median_ms=cuda_ms(lambda: lib.row_median_launch(
                  xm.data_ptr(), out.data_ptr(), ROWS, w, threads, stream), reps),
              row_kth_smallest_ms=cuda_ms(lambda: lib.row_kth_smallest_launch(
                  xm.data_ptr(), out.data_ptr(), ROWS, w, w // 2, threads, stream), reps),
              row_median_weighted_ms=cuda_ms(lambda: lib.row_median_weighted_launch(
                  xg.data_ptr(), wts.data_ptr(), out.data_ptr(), ROWS, gpd.n_groups, gpd.total, threads, stream),
                  reps))
    thr = torch.from_numpy(rng.uniform(0.0, 1.0, ROWS).astype(np.float32)).to(dev)
    keep = gene.THREADS
    for threads in (128, 256, 512, 1024):
        gene.THREADS = threads
        _emit(sweep="gene_project", threads=threads,
              ms=cuda_ms(lambda: gene.gene_project_cuda(xm, thr, gpd, gate=True), reps))
    gene.THREADS = keep
    del xm, xg
    x = torch.from_numpy(rng.standard_normal((ROWS, packed_width(plan)), dtype=np.float32)).to(dev)
    ref = rng.standard_normal((2, packed_width(plan)), dtype=np.float32)
    ref2 = torch.from_numpy(np.stack([ref.min(0), ref.max(0)])).to(dev)
    keep = fused.THREADS
    for threads in (128, 256, 384, 512):
        fused.THREADS = threads
        _emit(sweep="fused_window", threads=threads,
              ms=cuda_ms(lambda: fused.fused_center_smooth_median_cuda(x, ref2, plan, lfc_clip=3.0, n_ref=2), reps))
    fused.THREADS = keep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of the checkout to compare with")
    ap.add_argument("--sweep", action="store_true", help="time this tree's kernels at other block sizes")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare: torch.cuda.is_available() is False — this script needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    _emit(card=smi, torch=torch.__version__, cuda=torch.version.cuda)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # chip_smoke's generators
    if args.parent is not None:
        with tempfile.TemporaryDirectory() as td:
            compare_kernels(build_parent(args.parent.resolve(), Path(td)), parent_select(args.parent.resolve()),
                            args.reps)
    if args.sweep:
        sweep(args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
