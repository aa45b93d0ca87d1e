"""Time this tree's kernels against another checkout's, in turns, on one card.

    python -m infercnvpy_tpu_torch.ops.compare --parent DIR [--sweep] [--e2e [CASE ...]] [--no-kernels]

``DIR`` is the root of another checkout of the repository whose kernels still
have the bisection select's C interface (``fused_window_launch`` taking
``gmap`` and ``small_off``, ``gene_project_launch`` taking one ``gidx``), e.g.

    mkdir parent_tree && git archive <commit> | tar -x -C parent_tree

Its ``csrc/`` is built into a second library in a temporary directory and the
kernels are launched through ctypes with their index tables uploaded once, so
what is timed is the kernel alone on both sides.  At 16,384 rows of the
benchmark genome (20,000 genes, window 100, step 10) each of K1-K5 is timed
in the order parent, this tree, this tree, parent (CUDA events around
``--reps`` launches in a row, median of 5 such runs after a warm-up), and this tree's result is held against
the parent's (K2, K4, K5 and ungated K3 bit for bit; K1 at rtol 1e-5 /
atol 1e-6).

``--sweep`` times this tree's kernels at other block sizes (32 threads is one
warp per row).  ``--e2e [CASE ...]`` runs the named cases (all of
:data:`E2E_CASES` without names) from both trees, in the same order, one
process per turn: ``tl.infercnv`` on the 102,400-cell and the 30,000-cell
gene inputs of ``chip_smoke.py``, the downstream chain of its phase 9b
(``tl.pca`` → ``pp.neighbors`` → ``tl.leiden`` → ``tl.cnv_score`` →
``tl.umap``) on the 102,400-cell ``X_cnv``, and the plain pipeline's paths:
``tl.infercnv`` on float64 input on the card (the plain pipeline in float64)
and on the CPU in float32 and float64 at 20,480 cells, and the plain version
of K1 at 16,384 rows in float32 and float64 on the card.  ``--no-kernels``
skips the kernel comparison, for a parent whose kernels have this tree's C
interface.  Prints one JSON line per measurement; needs a CUDA device.
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
PARENT_SIGNATURES = {
    "fused_window_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    "row_median_launch": (_P, _P, _I, _I, _P),
    "row_median_weighted_launch": (_P, _P, _P, _I, _I, _I, _P),
    "row_kth_smallest_launch": (_P, _P, _I, _I, _I, _P),
    "gene_project_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

E2E_SNIPPET = """
import json, sys, time
import numpy as np, pandas as pd, torch
import chip_smoke as cs
import infercnvpy_tpu_torch as tcnv
n_cells, gene_values, runs, chain = int(sys.argv[1]), sys.argv[2] == "1", int(sys.argv[3]), sys.argv[4] == "1"
dtype, device = sys.argv[5], sys.argv[6]
var = cs.make_var(cs.N_GENES)
expr = cs.make_csr(n_cells, cs.N_GENES, cs.DENSITY).astype(dtype)
labels = np.array(["tumor"] * n_cells, dtype=object)
labels[: cs.N_NORMAL // 2] = "normal_a"
labels[cs.N_NORMAL // 2 : cs.N_NORMAL] = "normal_b"
obs = pd.DataFrame({"cell_type": pd.Categorical(labels)}, index=[f"cell_{i}" for i in range(n_cells)])
kw = dict(reference_key="cell_type", reference_cat=["normal_a", "normal_b"], device=device, inplace=False,
          calculate_gene_values=gene_values)
adata = tcnv.AnnData(X=expr, obs=obs, var=var)
if chain:
    tcnv.tl.infercnv(adata, **{**kw, "inplace": True})
    # the first chain is a warm-up (it may build the Leiden library)
    print(json.dumps([cs._downstream_chain(adata) for _ in range(runs + 1)][1:]))
    sys.exit(0)
tcnv.tl.infercnv(adata, **kw)
torch.cuda.synchronize()
walls = []
for _ in range(runs):
    t = time.perf_counter()
    tcnv.tl.infercnv(adata, **kw)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
print(json.dumps(walls))
"""

PLAIN_K1_SNIPPET = """
import json, sys
import numpy as np, torch
import chip_smoke as cs
from infercnvpy_tpu_torch.genome import build_window_plan
from infercnvpy_tpu_torch.ops.fused import fused_center_smooth_median_plain
from infercnvpy_tpu_torch.ops.infercnv_kernel import packed_width
rows, runs, dtype = int(sys.argv[1]), int(sys.argv[3]), getattr(torch, sys.argv[5])
plan = build_window_plan(cs.make_var(cs.N_GENES), 100, 10)
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.standard_normal((rows, packed_width(plan)))).to("cuda", dtype)
ref2 = torch.from_numpy(np.sort(rng.standard_normal((2, packed_width(plan))) * 0.1, axis=0)).to("cuda", dtype)
def call():
    fused_center_smooth_median_plain(x, ref2, plan, lfc_clip=3.0, n_ref=2)
call()
ms = []
for _ in range(runs):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(10):
        call()
    b.record()
    torch.cuda.synchronize()
    ms.append(a.elapsed_time(b) / 10)
print(json.dumps(ms))
"""

#: name -> (snippet, cells or rows, gene values, chain, dtype, device); the walls are seconds, the plain K1's ms
E2E_CASES = {
    "infercnv_102400": (E2E_SNIPPET, 102_400, "0", "0", "float32", "cuda"),
    "infercnv_gene_30000": (E2E_SNIPPET, 30_000, "1", "0", "float32", "cuda"),
    "downstream_102400": (E2E_SNIPPET, 102_400, "0", "1", "float32", "cuda"),
    "infercnv_f64_102400": (E2E_SNIPPET, 102_400, "0", "0", "float64", "cuda"),
    "infercnv_cpu_f32_20480": (E2E_SNIPPET, 20_480, "0", "0", "float32", "cpu"),
    "infercnv_cpu_f64_20480": (E2E_SNIPPET, 20_480, "0", "0", "float64", "cpu"),
    "plain_k1_f32_ms": (PLAIN_K1_SNIPPET, ROWS, "0", "0", "float32", "cuda"),
    "plain_k1_f64_ms": (PLAIN_K1_SNIPPET, ROWS, "0", "0", "float64", "cuda"),
}


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def build_parent(parent: Path, out_dir: Path) -> ctypes.CDLL:
    """Compile ``parent``'s ``csrc/*.cu`` into ``out_dir`` and load it with the bisection kernels' signatures."""
    from . import _build

    lib_path = out_dir / "libparent.so"
    _build.compile_sources(sorted((parent / "infercnvpy_tpu_torch" / "csrc").glob("*.cu")), lib_path)
    return _build.bind(ctypes.CDLL(str(lib_path)), PARENT_SIGNATURES)


def cuda_ms(fn, reps: int, rounds: int = 5) -> float:
    """Time of one ``fn()`` in ms: CUDA events around ``reps`` launches in a row, median of ``rounds`` such runs.

    The launches of a run queue up behind each other, so the host's work per
    launch hides behind the card's and the quotient is the kernel's time.
    """
    import torch

    fn()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def _turns(name: str, parent_fn, change_fn, reps: int, **extra) -> None:
    order = [("parent", parent_fn), ("change", change_fn), ("change", change_fn), ("parent", parent_fn)]
    ms = {"parent": [], "change": []}
    for who, fn in order:
        ms[who].append(cuda_ms(fn, reps))
    _emit(kernel=name, rows=ROWS, parent_ms=ms["parent"], change_ms=ms["change"],
          speedup=float(np.mean(ms["parent"]) / np.mean(ms["change"])), **extra)


def _checked(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def compare_kernels(plib: ctypes.CDLL, reps: int) -> None:
    import torch

    import chip_smoke as cs

    from ..genome import build_window_plan
    from . import fused, gene, select
    from ._build import current_stream, library
    from .infercnv_kernel import packed_width, small_offsets

    dev = torch.device("cuda")
    plan = build_window_plan(cs.make_var(cs.N_GENES), 100, 10)
    rng = np.random.default_rng(0)
    width = packed_width(plan)
    stream = lambda: current_stream(dev)  # noqa: E731

    # K1
    x = torch.from_numpy(rng.standard_normal((ROWS, width), dtype=np.float32)).to(dev)
    ref = rng.standard_normal((2, width), dtype=np.float32)
    ref2 = torch.from_numpy(np.stack([ref.min(0), ref.max(0)])).to(dev)
    gmap = torch.from_numpy(fused.final_gather_map(plan)).to(dev)
    soff = torch.from_numpy(small_offsets(plan)).to(dev)
    p_out = torch.empty((ROWS, plan.n_windows), dtype=torch.float32, device=dev)
    p_stats = torch.empty((ROWS, 3), dtype=torch.float32, device=dev)
    s = plan.step

    def k1_parent():
        _checked(plib.fused_window_launch(
            x.data_ptr(), ref2.data_ptr(), gmap.data_ptr(), soff.data_ptr(), p_out.data_ptr(), p_stats.data_ptr(),
            ROWS, width, plan.n_windows, fused._conv_region_windows(plan), plan.packed_len // s, s,
            plan.window_size, 0, 3.0, float(np.float32(1.0 / plan.pyramid_sum)), stream()), "parent K1")

    def k1_change():
        return fused.fused_center_smooth_median_cuda(x, ref2, plan, lfc_clip=3.0, n_ref=2)

    k1_parent()
    got = k1_change()
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], p_out, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[3], p_stats[:, 2], rtol=1e-5, atol=1e-6)
    _turns("fused_window", k1_parent, k1_change, reps, max_abs_diff=float((got[0] - p_out).abs().max()))
    del x, p_out, got

    # K3, gated
    gpd = gene.gene_projection_data(plan)
    xw = torch.from_numpy(rng.standard_normal((ROWS, plan.n_windows), dtype=np.float32)).to(dev)
    thr = torch.from_numpy(rng.uniform(0.0, 1.0, ROWS).astype(np.float32)).to(dev)
    tabs = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
            for a in (gpd.g_lo, gpd.g_hi, gpd.g_counts, gpd.gidx_sorted)]
    g_out = torch.empty((ROWS, gpd.total), dtype=torch.float32, device=dev)

    def k3_parent(gate=1):
        _checked(plib.gene_project_launch(
            xw.data_ptr(), thr.data_ptr(), *(t.data_ptr() for t in tabs), g_out.data_ptr(), ROWS, plan.n_windows,
            gpd.n_groups, gpd.total, gate, stream()), "parent K3")

    for gate in (0, 1):
        k3_parent(gate)
        got = gene.gene_project_cuda(xw, thr, gpd, gate=bool(gate))
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), g_out.view(torch.int32)):
            raise AssertionError(f"K3 gate={gate}: this tree's result differs from the parent's")
        del got
    _turns("gene_project", k3_parent, lambda: gene.gene_project_cuda(xw, thr, gpd, gate=True), reps)
    del g_out, xw

    # K2, K5 at 1,793; K4 at 1,991 with the plan's weights
    xm = torch.from_numpy(rng.standard_normal((ROWS, plan.n_windows), dtype=np.float32)).to(dev)
    m_out = torch.empty((ROWS,), dtype=torch.float32, device=dev)
    w = plan.n_windows

    def same(got, what):
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), m_out.view(torch.int32)):
            raise AssertionError(f"{what}: this tree's result differs from the parent's")

    def k2_parent():
        _checked(plib.row_median_launch(xm.data_ptr(), m_out.data_ptr(), ROWS, w, stream()), "parent K2")

    k2_parent()
    same(select.row_median_cuda(xm), "K2")
    _turns("row_median", k2_parent, lambda: select.row_median_cuda(xm), reps)

    def k5_parent():
        _checked(plib.row_kth_smallest_launch(xm.data_ptr(), m_out.data_ptr(), ROWS, w, w // 2, stream()), "parent K5")

    k5_parent()
    same(select.row_kth_smallest_cuda(xm, w // 2), "K5")
    _turns("row_kth_smallest", k5_parent, lambda: select.row_kth_smallest_cuda(xm, w // 2), reps)

    xg = torch.from_numpy(rng.standard_normal((ROWS, gpd.n_groups), dtype=np.float32)).to(dev)
    wts = torch.from_numpy(gpd.g_counts.astype(np.int32)).to(dev)

    def k4_parent():
        _checked(plib.row_median_weighted_launch(
            xg.data_ptr(), wts.data_ptr(), m_out.data_ptr(), ROWS, gpd.n_groups, gpd.total, stream()), "parent K4")

    k4_parent()
    same(select.row_median_weighted_cuda(xg, wts), "K4")
    lib = library()
    c_out = torch.empty_like(m_out)

    def k4_change():
        # the wrapper's checks of the weights synchronise with the host; launch as the parent is launched
        _checked(lib.row_median_weighted_launch(
            xg.data_ptr(), wts.data_ptr(), c_out.data_ptr(), ROWS, gpd.n_groups, gpd.total, select.THREADS,
            stream()), "K4")

    _turns("row_median_weighted", k4_parent, k4_change, reps)


def sweep(reps: int) -> None:
    """This tree's kernels at other block sizes (32 threads: one warp per row)."""
    import torch

    import chip_smoke as cs

    from ..genome import build_window_plan
    from . import fused, gene, select
    from .infercnv_kernel import packed_width

    dev = torch.device("cuda")
    plan = build_window_plan(cs.make_var(cs.N_GENES), 100, 10)
    gpd = gene.gene_projection_data(plan)
    rng = np.random.default_rng(1)
    xm = torch.from_numpy(rng.standard_normal((ROWS, plan.n_windows), dtype=np.float32)).to(dev)
    xg = torch.from_numpy(rng.standard_normal((ROWS, gpd.n_groups), dtype=np.float32)).to(dev)
    wts = torch.from_numpy(gpd.g_counts.astype(np.int32)).to(dev)
    keep = select.THREADS
    for threads in (32, 64, 128, 256, 512, 1024):
        select.THREADS = threads
        _emit(sweep="selects", threads=threads,
              row_median_ms=cuda_ms(lambda: select.row_median_cuda(xm), reps),
              row_kth_smallest_ms=cuda_ms(lambda: select.row_kth_smallest_cuda(xm, plan.n_windows // 2), reps),
              row_median_weighted_ms=cuda_ms(lambda: select.row_median_weighted_cuda(xg, wts), reps))
    select.THREADS = keep
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


def compare_e2e(parent: Path, runs: int, names) -> None:
    here = Path(__file__).resolve().parents[2]
    for what in names or E2E_CASES:
        snippet, n_cells, gene_values, chain, dtype, device = E2E_CASES[what]
        walls = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent"):
            root = parent if who == "parent" else here
            out = subprocess.run(
                [sys.executable, "-c", snippet, str(n_cells), gene_values, str(runs), chain, dtype, device],
                cwd=root, capture_output=True, text=True, timeout=1500,
            )
            if out.returncode != 0:
                raise RuntimeError(f"{who} {what} failed:\n{out.stderr[-4000:]}")
            got = json.loads(out.stdout.strip().splitlines()[-1])
            # a chain run's wall is the sum of its stages'
            walls[who].append([sum(r.values()) for r in got] if chain == "1" else got)
            if chain == "1":
                _emit(e2e=what, who=who, stages_sec=got)
        _emit(e2e=what, parent_wall_sec=walls["parent"], change_wall_sec=walls["change"],
              parent_median=float(np.median(np.concatenate(walls["parent"]))),
              change_median=float(np.median(np.concatenate(walls["change"]))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of the checkout to compare with")
    ap.add_argument("--sweep", action="store_true", help="time this tree's kernels at other block sizes")
    ap.add_argument("--e2e", nargs="*", choices=sorted(E2E_CASES), metavar="CASE",
                    help="also compare these walls (every case without names): " + ", ".join(E2E_CASES))
    ap.add_argument("--no-kernels", action="store_true", help="skip the kernel comparison")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--runs", type=int, default=3, help="timed tl.infercnv runs per process")
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
    if args.parent is not None and not args.no_kernels:
        with tempfile.TemporaryDirectory() as td:
            compare_kernels(build_parent(args.parent.resolve(), Path(td)), args.reps)
    if args.sweep:
        sweep(args.reps)
    if args.e2e is not None:
        if args.parent is None:
            raise SystemExit("--e2e needs --parent")
        compare_e2e(args.parent.resolve(), args.runs, args.e2e)
    return 0


if __name__ == "__main__":
    sys.exit(main())
