#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``infercnvpy_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero with no ``ok`` line):

1. device   — needs ``torch.cuda.is_available()``; prints the card's
              ``nvidia-smi`` name and power limit and the torch / CUDA versions
2. build    — compiles the CUDA kernels from ``infercnvpy_tpu_torch/csrc``
              with nvcc for sm_90a (one nvcc per source, all at once) and,
              beside them, the native host packer with g++
3. kernels  — each kernel against its plain PyTorch version on the same CUDA
              tensors: the fused window kernel at 16384 cells × 20000 genes
              (rtol 1e-5, atol 1e-6) and on the synthetic genome; the row
              median kernel bit for bit; CUDA-event times of both versions;
              then the shapes where the staged kernel can break: 1, 133 and
              15,000 rows, a width off a multiple of 4 (rows off 16 bytes),
              window / step 250 / 25 and 40 / 7 (the generic instantiation),
              60,000 genes (a row wider than shared memory),
              each also bit-identical on a second launch; selects on
              all-equal, two-valued, signed-zero, infinite and denormal rows
3b. write probe — the write-bandwidth kernel in both modes at 16,384 ×
              19,968 against its plain version, bit for bit; the card's
              write rate through ``ops.probe.write_bandwidth``
4. e2e      — ``tl.infercnv`` with default parameters on a 102,400 × 20,000
              CSR AnnData at 5 % density (pipelined: native packer, copy
              stream); checks the result and that every batch went through
              the fused kernel
4b. pipeline — the pipelined result bit for bit against the serialized
              (``stats``) run; one pipelined run under ``profiling.trace``:
              device idle share, kernel device time, wall time
4c. bf16    — ``transfer_dtype="bfloat16"``: fewer host→device bytes than
              f32, chunk 0 against the port's CPU bf16 path, gate agreement
              with the f32 run
4d. checkpoint — ``checkpoint_dir``: 3 of 7 batch files deleted, the rerun
              launches the fused kernel 3 times and is bit-identical; a
              changed ``lfc_clip`` raises
5. parity   — chunk 0 against the port's CPU path, and a rerun of the first
              15,000 cells bit for bit
6. gene kernels — the gene projection kernel against its plain version at
              16384 cells × 1793 windows (→ 19,910 gene columns), gated and
              ungated, and on the synthetic genome; CUDA-event times; odd
              and even row counts at gene counts 0, 1, 2 and 3 modulo 4 (row
              starts off 16 bytes), ungated bit for bit
7. selects  — the weighted median kernel at 16384 × 1991 (the bench plan's
              genes per coverage group as weights, odd and even totals) and
              the k-th smallest kernel at 16384 × 1793, bit for bit; times
8. gene e2e — ``tl.infercnv(calculate_gene_values=True)`` on a 30,000 ×
              20,000 CSR: every batch through the gene kernel, ``X_cnv`` bit
              for bit as without the option, chunk 0 against the CPU path,
              and a checkpoint resume of one of the two batches with the gene
              layer bit for bit
9. report   — the card line, a JSON line of kernel numbers (each kernel
              with its bytes, its bound on an H100 from those bytes and
              operations, its share of the bound and, where one PyTorch call
              computes the same function, that call's time), then
              ``{"ok": true, "device": {...}}`` as the last line

It imports nothing of JAX and nothing of ``infercnvpy_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

N_CELLS = 102_400
N_GENES = 20_000
DENSITY = 0.05
N_NORMAL = 4_000
KERNEL_ROWS = 16_384
K1_RTOL, K1_ATOL = 1e-5, 1e-6
K3_RTOL, K3_ATOL = 1e-5, 1e-6
GENE_CELLS = 30_000
BATCH = 15_000
E2E_KW = dict(lfc_clip=3, window_size=100, step=10, dynamic_threshold=1.5, chunksize=5000, batch_cells=None, dtype=None)


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


T0 = time.perf_counter()


def make_var(n_genes: int, seed: int = 0):
    """Genome of the benchmark: 22 autosomes, genes proportional to chromosome length."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    sizes = np.array([248, 242, 198, 190, 181, 171, 159, 145, 138, 134, 135, 133,
                      114, 107, 102, 90, 83, 80, 59, 64, 47, 51], dtype=float)
    counts = np.maximum(1, (sizes / sizes.sum() * n_genes)).astype(int)
    counts[0] += n_genes - counts.sum()
    rows = []
    for c, k in enumerate(counts):
        starts = np.sort(rng.integers(1, int(sizes[c] * 1e6), size=k))
        rows.extend((f"chr{c + 1}", int(s)) for s in starts)
    var = pd.DataFrame(rows, columns=["chromosome", "start"])
    var["end"] = var["start"] + 1000
    var.index = pd.Index([f"gene_{i}" for i in range(len(var))])
    return var


def make_csr(n_cells: int, n_genes: int, density: float, seed: int = 1):
    """Random canonical CSR: ``density × n_genes`` entries per row, values normal²."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    per_row = max(1, int(n_genes * density))
    indptr = np.arange(n_cells + 1, dtype=np.int64) * per_row
    indices = rng.integers(0, n_genes, size=n_cells * per_row, dtype=np.int32)
    data = rng.normal(size=n_cells * per_row).astype(np.float32) ** 2
    expr = sp.csr_matrix((data, indices, indptr), shape=(n_cells, n_genes))
    expr.sum_duplicates()
    return expr


def cuda_ms(fn, reps: int = 5, inner: int = 10) -> float:
    """Time of one ``fn()`` in ms: CUDA events around ``inner`` calls in a row, median of ``reps`` such runs.

    The calls of a run queue up behind each other, so the host's work per
    launch hides behind the card's and the quotient is the device time of a call.
    """
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


# NVIDIA's data sheet for the H100 SXM: device memory rate and the float32
# rate outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time the card could take: the larger of bytes / memory rate and operations / f32 rate."""
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": int(n_bytes), "operations": int(n_ops), "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def phase_device() -> tuple[str, str]:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")
    return smi, torch.cuda.get_device_name(0)


def phase_build() -> float:
    from infercnvpy_tpu_torch import native
    from infercnvpy_tpu_torch.ops import _build

    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        packer = pool.submit(native.build)
        _build.build(verbose=True)
        packer_path = packer.result()
    _build.library()
    native.library()
    sec = time.perf_counter() - t
    log(f"kernels and native packer built and loaded in {sec:.1f}s ({_build.nvcc_path()}; {packer_path.name})")
    return sec


def _k1_case(plan, rows: int, n_ref: int, seed: int) -> dict:
    """K1 vs its plain version on the same CUDA tensors, and a second launch bit for bit."""
    import torch

    from infercnvpy_tpu_torch.ops.fused import fused_center_smooth_median_cuda, fused_center_smooth_median_plain
    from infercnvpy_tpu_torch.ops.infercnv_kernel import packed_width

    rng = np.random.default_rng(seed)
    width = packed_width(plan)
    x = torch.from_numpy(rng.standard_normal((rows, width), dtype=np.float32)).cuda()
    ref = rng.standard_normal((n_ref, width), dtype=np.float32)
    ref2 = np.concatenate([ref, ref]) if n_ref == 1 else np.stack([ref.min(0), ref.max(0)])
    ref2 = torch.from_numpy(ref2).cuda()
    kw = dict(lfc_clip=3.0, n_ref=n_ref)
    got = fused_center_smooth_median_cuda(x, ref2, plan, **kw)
    again = fused_center_smooth_median_cuda(x, ref2, plan, **kw)
    want = fused_center_smooth_median_plain(x, ref2, plan, **kw)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        if not torch.equal(g.view(torch.int32), a.view(torch.int32)):
            raise AssertionError(f"K1 ({rows}, {width}): a second launch changed bits")
    out_k, rs_k, rsq_k, med_k = got
    out_p, rs_p, rsq_p, med_p = want
    assert out_k.shape == (rows, plan.n_windows), out_k.shape
    torch.testing.assert_close(out_k, out_p, rtol=K1_RTOL, atol=K1_ATOL)
    torch.testing.assert_close(med_k, med_p, rtol=K1_RTOL, atol=K1_ATOL)
    # a row sum adds n_windows terms, each within the element bar
    sum_atol = K1_ATOL * plan.n_windows
    torch.testing.assert_close(rs_k, rs_p, rtol=K1_RTOL, atol=sum_atol)
    torch.testing.assert_close(rsq_k, rsq_p, rtol=K1_RTOL, atol=sum_atol)
    err = float((out_k - out_p).abs().max())
    return {"x": x, "ref2": ref2, "kw": kw, "max_abs_err": err}


def _k1_edges(plan, synthetic_var) -> float:
    """K1 at the shapes where the staged design can break; returns the largest |kernel - plain|."""
    from infercnvpy_tpu_torch.genome import build_window_plan
    from infercnvpy_tpu_torch.ops import _build
    from infercnvpy_tpu_torch.ops.fused import stage_plan
    from infercnvpy_tpu_torch.ops.infercnv_kernel import packed_width

    worst = 0.0
    for rows in (1, 133, BATCH):
        err = _k1_case(plan, rows, n_ref=2, seed=10 + rows)["max_abs_err"]
        worst = max(worst, err)
        log(f"K1 edge: {rows} rows x {packed_width(plan)}: max |kernel - plain| = {err:.3e}, rerun bit-identical")
    # a packed width off a multiple of 4: every row but the first starts off 16 bytes
    odd = None
    for drop in range(4):
        small = synthetic_var[synthetic_var["chromosome"] == "chr21"].index[:drop]
        cand = build_window_plan(synthetic_var.drop(index=small), 100, 10)
        if packed_width(cand) % 4:
            odd = cand
            break
    if odd is None or not odd.n_small:
        raise AssertionError("no synthetic plan with small chromosomes and a packed width off a multiple of 4")
    for rows, n_ref in ((1, 2), (133, 1)):
        err = _k1_case(odd, rows, n_ref=n_ref, seed=20 + rows)["max_abs_err"]
        worst = max(worst, err)
        log(f"K1 edge: width {packed_width(odd)} (= {packed_width(odd) % 4} mod 4), {rows} rows, n_ref={n_ref}: "
            f"max |kernel - plain| = {err:.3e}")
    for window, step in ((250, 25), (40, 7)):
        gplan = build_window_plan(make_var(N_GENES), window, step)
        err = _k1_case(gplan, 133, n_ref=2, seed=window)["max_abs_err"]
        worst = max(worst, err)
        log(f"K1 edge: window {window} / step {step} ({gplan.n_windows} windows, generic instantiation): "
            f"max |kernel - plain| = {err:.3e}")
    wide = build_window_plan(make_var(60_000), 100, 10)
    lib = _build.library()
    stage = stage_plan(wide, lib.fused_window_smem_budget(2), lib.fused_window_smem_budget(1))
    if stage["n_tiles"] < 2 or packed_width(wide) * 4 < lib.fused_window_smem_budget(1):
        raise AssertionError(f"the 60,000-gene plan was expected to be wider than shared memory, got {stage}")
    err = _k1_case(wide, 64, n_ref=2, seed=60)["max_abs_err"]
    worst = max(worst, err)
    log(f"K1 edge: 60,000 genes, width {packed_width(wide)} in "
        f"{stage['n_tiles']} column tiles of {stage['tile_conv']} conv positions ({stage['smem_bytes']} B of "
        f"shared memory): "
        f"max |kernel - plain| = {err:.3e}")
    return worst


def _select_edges() -> None:
    """K2, K4, K5 on rows of equal, two-valued, signed-zero, infinite and denormal values, bit for bit."""
    import torch

    from infercnvpy_tpu_torch.ops import select as ts

    for width in (1, 2, 257, 1793, 1794, 5000):
        x = np.random.default_rng(width).normal(size=(64, width)).astype(np.float32)
        x[:16] = 0.75
        x[16:32] = np.where(x[16:32] > 0, np.float32(1.5), np.float32(-2.0))
        x[32:40] = np.where(x[32:40] > 0, np.float32(0.0), np.float32(-0.0))
        x[40] = np.inf
        x[41, : width // 2] = -np.inf
        x[42] *= np.float32(1e-42)
        xd = torch.from_numpy(x).cuda()
        _bit_identical(ts.row_median_cuda(xd), ts.row_median_plain(xd), f"K2 degenerate rows, width {width}")
        for k in sorted({0, width // 2, width - 1}):
            _bit_identical(ts.row_kth_smallest_cuda(xd, k), ts.row_kth_smallest_plain(xd, k),
                           f"K5 degenerate rows, width {width}, k={k}")
        wts = np.random.default_rng(1).integers(0, 9, size=width)
        wts[0] += 1
        for parity in (0, 1):
            w2 = wts.copy()
            w2[0] += (int(w2.sum()) + parity) % 2
            _bit_identical(ts.row_median_weighted_cuda(xd, w2), ts.row_median_weighted_plain(xd, w2),
                           f"K4 degenerate rows, width {width}, total {int(w2.sum())}")
    log("selects on all-equal, two-valued, signed-zero, infinite and denormal rows (widths 1 to 5000): bit-identical")


def phase_kernels() -> list[dict]:
    import torch

    from infercnvpy_tpu_torch.datasets import synthetic_cnv_dataset
    from infercnvpy_tpu_torch.genome import build_window_plan
    from infercnvpy_tpu_torch.ops.fused import (
        fused_center_smooth_median_cuda,
        fused_center_smooth_median_plain,
        window_tasks,
    )
    from infercnvpy_tpu_torch.ops.infercnv_kernel import packed_width
    from infercnvpy_tpu_torch.ops.select import row_median_cuda, row_median_plain

    # the plain versions' conv and matmul run in full float32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    plan = build_window_plan(make_var(N_GENES), 100, 10)
    assert (packed_width(plan), plan.n_windows, plan.n_small) == (20480, 1793, 0), (
        packed_width(plan), plan.n_windows, plan.n_small)
    bench = _k1_case(plan, KERNEL_ROWS, n_ref=2, seed=0)
    k1_err = bench["max_abs_err"]
    log(f"K1 fused_window {KERNEL_ROWS}x{packed_width(plan)} -> {plan.n_windows} windows: "
        f"max |kernel - plain| = {bench['max_abs_err']:.3e} (bar rtol {K1_RTOL}, atol {K1_ATOL})")
    k1_ms = cuda_ms(lambda: fused_center_smooth_median_cuda(bench["x"], bench["ref2"], plan, **bench["kw"]))
    k1_plain_ms = cuda_ms(lambda: fused_center_smooth_median_plain(bench["x"], bench["ref2"], plan, **bench["kw"]))
    log(f"K1 time: kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms (CUDA events around 10 calls in a row, median of 5 runs)")
    del bench

    var = synthetic_cnv_dataset(n_cells=8, n_genes=4000, seed=0).var
    var = var[~var["chromosome"].isin(["chrX", "chrY"])]
    splan = build_window_plan(var, 100, 10)
    assert (splan.n_windows, splan.n_small) == (180, 4), (splan.n_windows, splan.n_small)
    syn = _k1_case(splan, KERNEL_ROWS, n_ref=1, seed=1)
    k1_err = max(k1_err, syn["max_abs_err"])
    log(f"K1 fused_window synthetic genome ({splan.n_small} small chromosomes, {splan.n_windows} windows, "
        f"n_ref=1): max |kernel - plain| = {syn['max_abs_err']:.3e}")
    del syn
    k1_err = max(k1_err, _k1_edges(plan, var))

    k2 = []
    rng = np.random.default_rng(2)
    for w in (1793, 1794):
        x = torch.from_numpy(rng.standard_normal((KERNEL_ROWS, w), dtype=np.float32)).cuda()
        got = row_median_cuda(x)
        want = row_median_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            raise AssertionError(f"K2 row_median ({KERNEL_ROWS}, {w}): {bad} rows differ from the plain median")
        t_k = cuda_ms(lambda: row_median_cuda(x))
        t_p = cuda_ms(lambda: row_median_plain(x))
        # the one PyTorch call for the same function: a yardstick, never called by the port
        lib_out = torch.quantile(x, 0.5, dim=1, interpolation="midpoint")
        torch.testing.assert_close(lib_out, got, rtol=1e-6, atol=1e-7)
        t_l = cuda_ms(lambda: torch.quantile(x, 0.5, dim=1, interpolation="midpoint"))
        k2.append((w, t_k, t_p, t_l))
        log(f"K2 row_median ({KERNEL_ROWS}, {w}): bit-identical; kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
            f"torch.quantile(midpoint) {t_l:.3f} ms")
    _select_edges()

    return [
        {
            "name": "fused_window", "route": "cuda", "source": "infercnvpy_tpu_torch/csrc/fused_window.cu",
            "replaces": "infercnvpy_tpu/ops/pallas_fused.py:187", "launches": None,
            "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms, "library_ms": None,
            # x read once, windows and stats written once, the reference rows and the task table read once;
            # one multiply-add per tap, two centring clips per input element
            **bound(KERNEL_ROWS * (20480 + 1793 + 3) * 4 + 2 * 20480 * 4 + len(window_tasks(plan)) * 16,
                    KERNEL_ROWS * (1793 * 100 * 2 + 20480 * 5)),
        },
        {
            "name": "row_median", "route": "cuda", "source": "infercnvpy_tpu_torch/csrc/row_median.cu",
            "replaces": "infercnvpy_tpu/ops/pallas_select.py:79", "launches": None, "max_abs_err": 0.0,
            "ms": k2[0][1], "plain_ms": k2[0][2], "ms_even_width": k2[1][1], "plain_ms_even_width": k2[1][2],
            "library_ms": k2[0][3], "library": 'torch.quantile(x, 0.5, dim=1, interpolation="midpoint")',
            "library_ms_even_width": k2[1][3],
            # 4 passes, each a key compare and a histogram add per value
            **bound(KERNEL_ROWS * (1793 + 1) * 4, KERNEL_ROWS * 1793 * 4 * 2),
        },
    ]


def phase_probe(k1: dict) -> dict:
    """K6: the write probe against its plain version, then the card's write rate."""
    import torch

    from infercnvpy_tpu_torch.ops import probe

    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((probe.N, probe.X_COLS), generator=gen, device="cuda", dtype=torch.float32)
    gb = probe.N * probe.W * 4 / 1e9
    plain_ms = {}
    for mode in probe.MODES:
        got = probe.write_probe_cuda(x, probe.W, mode)
        want = probe.write_probe_plain(x, probe.W, mode)
        _bit_identical(got, want, f"K6 write_probe {mode} ({probe.N}, {probe.W})")
        del got, want
        plain_ms[mode] = cuda_ms(lambda: probe.write_probe_plain(x, probe.W, mode))
    del x
    # the probe's own path, counted: write_bandwidth in both modes
    probe.write_probe_cuda.launches = 0
    rate = {mode: probe.write_bandwidth(probe.N, probe.W, mode) for mode in probe.MODES}
    launches = probe.write_probe_cuda.launches
    for mode in probe.MODES:
        log(f"K6 write_probe {mode} ({probe.N}, {probe.W}), {gb:.3f} GB: bit-identical; kernel "
            f"{gb / rate[mode] * 1e3:.3f} ms ({rate[mode]:.1f} GB/s write), plain {plain_ms[mode]:.3f} ms "
            f"({gb / plain_ms[mode] * 1e3:.1f} GB/s)")
    ceiling = max(rate.values())
    out_gb = KERNEL_ROWS * 1793 * 4 / 1e9
    in_gb = KERNEL_ROWS * 20480 * 4 / 1e9
    log(f"K1 at {k1['ms']:.3f} ms writes {out_gb / k1['ms'] * 1e3:.1f} GB/s of output "
        f"({out_gb / k1['ms'] * 1e3 / ceiling:.2%} of the measured write rate) and reads "
        f"{in_gb / k1['ms'] * 1e3:.1f} GB/s of input")
    torch.cuda.empty_cache()
    return {
        "name": "write_probe", "route": "cuda", "source": "infercnvpy_tpu_torch/csrc/write_probe.cu",
        "replaces": "tools/probe_write_bw.py:14", "launches": launches, "max_abs_err": 0.0,
        "ms": gb / rate["blocks"] * 1e3, "plain_ms": plain_ms["blocks"],
        # its plain version is the one PyTorch call for the same function
        "library_ms": plain_ms["blocks"], "library": "ops.probe.write_probe_plain (one broadcast multiply)",
        **bound(probe.N * (probe.X_COLS + probe.W) * 4, probe.N * probe.W),
        "ms_bcast": gb / rate["bcast"] * 1e3, "plain_ms_bcast": plain_ms["bcast"],
        "write_gb_per_s": rate["blocks"], "write_gb_per_s_bcast": rate["bcast"],
    }


def _csr_equal(a, b) -> bool:
    return (
        a.shape == b.shape
        and np.array_equal(a.indptr, b.indptr)
        and np.array_equal(a.indices, b.indices)
        and np.array_equal(a.data.view(np.uint32), b.data.view(np.uint32))
    )


def phase_e2e() -> dict:
    import pandas as pd
    import torch

    import infercnvpy_tpu_torch as tcnv
    from infercnvpy_tpu_torch.genome import build_window_plan
    from infercnvpy_tpu_torch.tl._infercnv import _get_reference, _infercnv_compute

    t = time.perf_counter()
    var = make_var(N_GENES)
    expr = make_csr(N_CELLS, N_GENES, DENSITY)
    labels = np.array(["tumor"] * N_CELLS, dtype=object)
    labels[: N_NORMAL // 2] = "normal_a"
    labels[N_NORMAL // 2 : N_NORMAL] = "normal_b"
    obs = pd.DataFrame({"cell_type": pd.Categorical(labels)}, index=[f"cell_{i}" for i in range(N_CELLS)])
    adata = tcnv.AnnData(X=expr, obs=obs, var=var)
    cats = ["normal_a", "normal_b"]
    log(f"e2e input: {N_CELLS} x {N_GENES} CSR, nnz {expr.nnz:,} ({expr.nnz / N_CELLS / N_GENES:.2%}), "
        f"made in {time.perf_counter() - t:.1f}s")

    plan = build_window_plan(var, 100, 10)
    tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=cats)  # warm-up (allocator, caches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t = time.perf_counter()
    tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=cats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()

    res = adata.obsm["X_cnv"]
    assert res.shape == (N_CELLS, plan.n_windows) == (N_CELLS, 1793), res.shape
    assert adata.uns["cnv"]["chr_pos"] == plan.chr_pos
    assert np.isfinite(res.data).all()
    n_batches = -(-N_CELLS // 15_000)
    if launches["fused_window"] != n_batches:
        raise AssertionError(f"fused_window ran {launches['fused_window']} times for {n_batches} batches")
    log(f"e2e tl.infercnv: {wall:.3f}s wall, {N_CELLS / wall:,.0f} cells/s, X_cnv {res.shape} "
        f"nnz {res.nnz:,} ({res.nnz / np.prod(res.shape):.2%}), launches {launches}, "
        f"peak device memory {peak / 2**30:.3f} GiB")

    reference = _get_reference(adata, "cell_type", cats, None, None)
    stats: dict = {}
    masked = var[["chromosome", "start", "end"]]
    _, serial, _ = _infercnv_compute(
        expr, masked, reference, **E2E_KW, device=torch.device("cuda"), stats=stats, progress=False,
    )
    log("e2e stats run: " + json.dumps({k: (round(v, 6) if isinstance(v, float) else v) for k, v in stats.items()}))
    return {"adata": adata, "reference": reference, "launches": launches, "wall": wall, "stats": stats,
            "serial": serial, "expr": expr, "masked": masked, "cats": cats}


def _trace_summary(path: Path, wall: float) -> dict:
    """Device busy time (union of kernel / copy / memset spans), kernel time and idle share of a trace."""
    events = json.loads(path.read_text())["traceEvents"]
    spans, kernel_us, fused_us = [], 0.0, 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))))
        if e["cat"] == "kernel":
            kernel_us += float(e.get("dur", 0.0))
            if "fused_window" in e.get("name", ""):
                fused_us += float(e.get("dur", 0.0))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans:
        raise AssertionError(f"the trace {path} holds no device activity")
    return {"busy_sec": busy / 1e6, "kernel_sec": kernel_us / 1e6, "fused_window_sec": fused_us / 1e6,
            "idle_share": 1.0 - busy / 1e6 / wall, "n_device_events": len(spans)}


def phase_pipeline(e2e) -> dict:
    """The pipelined result against the serialized one, and one traced pipelined run."""
    import torch

    import infercnvpy_tpu_torch as tcnv
    from infercnvpy_tpu_torch import native, profiling

    got, want = e2e["adata"].obsm["X_cnv"], e2e["serial"]
    if not _csr_equal(got, want):
        raise AssertionError("the pipelined 102,400-cell result differs from the serialized (stats) run")
    log(f"pipelined result bit-identical to the serialized run (nnz {got.nnz:,})")

    packer = native.build()
    if not packer.exists():
        raise AssertionError(f"native packer library {packer} missing")
    native.coo_remap.calls = 0
    n_batches = -(-N_CELLS // BATCH)
    with tempfile.TemporaryDirectory() as td:
        with profiling.trace(td):
            # the wall clock stops before the profiler writes its trace
            t = time.perf_counter()
            tcnv.tl.infercnv(e2e["adata"], reference_key="cell_type", reference_cat=e2e["cats"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        summary = _trace_summary(Path(td) / profiling.TRACE_FILE, wall)
    if native.coo_remap.calls != n_batches:
        raise AssertionError(f"native coo_remap ran {native.coo_remap.calls} times for {n_batches} batches")
    if not _csr_equal(e2e["adata"].obsm["X_cnv"], want):
        raise AssertionError("the traced pipelined run differs from the serialized run")
    log(f"traced pipelined run: {wall:.3f}s wall, device busy {summary['busy_sec']:.6f}s "
        f"(kernels {summary['kernel_sec']:.6f}s, fused_window {summary['fused_window_sec']:.6f}s), "
        f"device idle {summary['idle_share']:.2%}; native coo_remap {native.coo_remap.calls} calls ({packer.name}); "
        f"the serial batch loop before the pipeline: idle 96.6 %, 4.759 s median wall on an H100 at 700 W")
    torch.cuda.synchronize()
    return {"wall": wall, **summary}


def phase_bf16(e2e) -> dict:
    """transfer_dtype="bfloat16" on the 102,400-cell run."""
    import torch

    import infercnvpy_tpu_torch as tcnv
    from infercnvpy_tpu_torch.tl._infercnv import _infercnv_compute

    stats: dict = {}
    _, serial_bf, _ = _infercnv_compute(
        e2e["expr"], e2e["masked"], e2e["reference"], **E2E_KW, device=torch.device("cuda"), stats=stats,
        progress=False, transfer_dtype="bfloat16",
    )
    f32_bytes = e2e["stats"]["h2d_bytes"]
    if not stats["h2d_bytes"] < f32_bytes or stats.get("transfer_dtype") != "bfloat16":
        raise AssertionError(f"bf16 h2d_bytes {stats['h2d_bytes']} not below f32's {f32_bytes}")
    adata = e2e["adata"]
    _, bf, _ = tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=e2e["cats"],
                                transfer_dtype="bfloat16", inplace=False)
    if not _csr_equal(bf, serial_bf):
        raise AssertionError("the pipelined bf16 run differs from the serialized bf16 run")
    f32 = adata.obsm["X_cnv"]
    flips = int((bf.astype(bool) != f32.astype(bool)).nnz)
    agree = 1.0 - flips / (f32.shape[0] * f32.shape[1])
    log(f"bf16 transfer: h2d {stats['h2d_bytes']:,} B vs f32 {f32_bytes:,} B; host_pack "
        f"{stats['host_pack_sec']:.3f}s, h2d {stats['h2d_sec']:.3f}s; gate agreement with the f32 run "
        f"{agree:.6%} ({flips:,} flips); pipelined bf16 run bit-identical to its serialized run")

    sub = adata[:5000]
    kw = dict(reference=e2e["reference"], inplace=False, transfer_dtype="bfloat16")
    _, gpu, _ = tcnv.tl.infercnv(sub, device="cuda", **kw)
    _, cpu, _ = tcnv.tl.infercnv(sub, device="cpu", **kw)
    same_gate, err = _chunk0_compare(gpu.toarray(), cpu.toarray(), "bf16 chunk 0")
    return {"h2d_bytes": stats["h2d_bytes"], "f32_h2d_bytes": f32_bytes, "gate_agreement_vs_f32": agree,
            "chunk0_gate_agreement": same_gate, "chunk0_max_abs_diff": err}


def _chunk0_compare(g: np.ndarray, c: np.ndarray, what: str) -> tuple[float, float]:
    """The phase-5 bars: gate pattern >= 99.99 %, values at rtol 1e-4 / atol 1e-5 where both are nonzero."""
    same_gate = float(((g != 0) == (c != 0)).mean())
    both = (g != 0) & (c != 0)
    err = float(np.abs(g[both] - c[both]).max()) if both.any() else 0.0
    log(f"{what} (5000 cells) GPU vs CPU: gate agrees on {same_gate:.6%} of entries, "
        f"max |diff| where both nonzero {err:.3e}")
    if same_gate < 0.9999:
        raise AssertionError(f"{what}: gate pattern agrees on only {same_gate:.6%} of entries")
    np.testing.assert_allclose(g[both], c[both], rtol=1e-4, atol=1e-5)
    return same_gate, err


def _expect_config_mismatch(run) -> None:
    try:
        run()
    except ValueError as e:
        if "DIFFERENT configuration" not in str(e):
            raise
        log(f"changed configuration refused: {e}")
        return
    raise AssertionError("a checkpoint of another configuration was not refused")


def phase_checkpoint(e2e) -> dict:
    """checkpoint_dir on the 102,400-cell run: resume after losing 3 of 7 batch files."""
    import infercnvpy_tpu_torch as tcnv

    adata = e2e["adata"]
    kw = dict(reference_key="cell_type", reference_cat=e2e["cats"], inplace=False)
    with tempfile.TemporaryDirectory() as td:
        t = time.perf_counter()
        _, full, _ = tcnv.tl.infercnv(adata, checkpoint_dir=td, **kw)
        first = time.perf_counter() - t
        if not _csr_equal(full, adata.obsm["X_cnv"]):
            raise AssertionError("the checkpointed run differs from the run without checkpoint_dir")
        files = sorted(Path(td).glob("batch_*.npz"))
        if len(files) != 7:
            raise AssertionError(f"{len(files)} batch files for 7 batches")
        for f in (files[1], files[3], files[6]):
            f.unlink()
        _reset_counts()
        t = time.perf_counter()
        _, resumed, _ = tcnv.tl.infercnv(adata, checkpoint_dir=td, **kw)
        again = time.perf_counter() - t
        launches = _read_counts()
        if launches["fused_window"] != 3:
            raise AssertionError(f"the resumed run launched fused_window {launches['fused_window']} times, not 3")
        if not _csr_equal(resumed, full):
            raise AssertionError("the resumed run differs from the uninterrupted run")
        _expect_config_mismatch(lambda: tcnv.tl.infercnv(adata, checkpoint_dir=td, lfc_clip=2.5, **kw))
    log(f"checkpoint: first run {first:.3f}s (7 batch files), resume of 3 of 7 batches {again:.3f}s with "
        f"fused_window launched {launches['fused_window']} times, bit-identical")
    return {"first_sec": first, "resume_sec": again, "resume_launches": launches["fused_window"]}


def phase_parity(adata, reference) -> None:
    import torch

    import infercnvpy_tpu_torch as tcnv

    sub = adata[:5000]
    _, gpu, _ = tcnv.tl.infercnv(sub, reference=reference, device="cuda", inplace=False)
    _, cpu, _ = tcnv.tl.infercnv(sub, reference=reference, device="cpu", inplace=False)
    _chunk0_compare(gpu.toarray(), cpu.toarray(), "chunk 0")

    sub = adata[:15000]
    _, first, _ = tcnv.tl.infercnv(sub, reference=reference, device="cuda", inplace=False)
    _, second, _ = tcnv.tl.infercnv(sub, reference=reference, device="cuda", inplace=False)
    torch.cuda.synchronize()
    if not _csr_equal(first, second):
        raise AssertionError("two runs of the first 15000 cells gave different CSR results")
    log(f"rerun of the first 15000 cells: bit-identical CSR (nnz {first.nnz:,})")


def _k3_case(plan, rows: int, seed: int) -> dict:
    """K3 vs its plain version on the same CUDA tensors, gated and ungated."""
    import torch

    from infercnvpy_tpu_torch.ops.gene import gene_project_cuda, gene_project_plain, gene_projection_data

    gpd = gene_projection_data(plan)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, plan.n_windows), dtype=np.float32)).cuda()
    thr = torch.from_numpy(rng.uniform(0.0, 1.0, rows).astype(np.float32)).cuda()
    errs = {}
    for gate in (False, True):
        got = gene_project_cuda(x, thr, gpd, gate=gate)
        want = gene_project_plain(x, thr, gpd, gate=gate)
        torch.cuda.synchronize()
        assert got.shape == (rows, gpd.total), got.shape
        if gate:
            # count in integers: a float32 mean over 3e8 entries cannot reach 1.0
            agree = 1.0 - int(((got == 0) != (want == 0)).sum()) / got.numel()
            if agree < 0.9999:
                raise AssertionError(f"K3 gated pattern agrees on only {agree:.6%} of entries")
            both = (got != 0) & (want != 0)
            torch.testing.assert_close(got[both], want[both], rtol=K3_RTOL, atol=K3_ATOL)
            errs["gated"] = float((got[both] - want[both]).abs().max()) if bool(both.any()) else 0.0
            errs["gate_agreement"] = agree
        else:
            torch.testing.assert_close(got, want, rtol=K3_RTOL, atol=K3_ATOL)
            errs["ungated"] = float((got - want).abs().max())
        del got, want
    return {"x": x, "thr": thr, "gpd": gpd, **errs}


def _k3_edges(synthetic_var) -> None:
    """K3 ungated, bit for bit, with rows that start 0, 4, 8 and 12 bytes off a 16-byte address."""
    import torch

    from infercnvpy_tpu_torch.genome import build_window_plan
    from infercnvpy_tpu_torch.ops.gene import gene_project_cuda, gene_project_plain, gene_projection_data

    seen = {}
    small = synthetic_var[synthetic_var["chromosome"] == "chr21"].index
    for drop in range(8):
        plan = build_window_plan(synthetic_var.drop(index=small[:drop]), 100, 10)
        gpd = gene_projection_data(plan)
        if gpd.total % 4 in seen:
            continue
        seen[gpd.total % 4] = gpd.total
        for rows in (1, 2, 133, 1024):
            rng = np.random.default_rng(rows + drop)
            x = torch.from_numpy(rng.standard_normal((rows, plan.n_windows), dtype=np.float32)).cuda()
            _bit_identical(gene_project_cuda(x, None, gpd, gate=False), gene_project_plain(x, None, gpd, gate=False),
                           f"K3 ungated, {rows} rows x {gpd.total} genes")
    if sorted(seen) != [0, 1, 2, 3]:
        raise AssertionError(f"gene counts modulo 4 covered: {seen}")
    log(f"K3 edge: 1, 2, 133 and 1024 rows at gene counts {sorted(seen.values())} (0, 1, 2, 3 modulo 4): "
        f"ungated bit-identical")


def phase_gene_kernels(write_rate: float) -> dict:
    import torch

    from infercnvpy_tpu_torch.datasets import synthetic_cnv_dataset
    from infercnvpy_tpu_torch.genome import build_window_plan
    from infercnvpy_tpu_torch.ops.gene import gene_project_cuda, gene_project_plain

    plan = build_window_plan(make_var(N_GENES), 100, 10)
    bench = _k3_case(plan, KERNEL_ROWS, seed=3)
    gpd = bench["gpd"]
    assert (plan.n_windows, gpd.total, gpd.n_groups, int((gpd.g_hi - gpd.g_lo).max()) + 1) == (1793, 19910, 1991, 10)
    log(f"K3 gene_project {KERNEL_ROWS}x{plan.n_windows} -> {gpd.total} genes ({gpd.n_groups} groups): "
        f"ungated max |kernel - plain| = {bench['ungated']:.3e} (bar rtol {K3_RTOL}, atol {K3_ATOL}); gated: "
        f"pattern agreement {bench['gate_agreement']:.6%}, max |diff| where both nonzero {bench['gated']:.3e}")
    x, thr = bench["x"], bench["thr"]
    ms = cuda_ms(lambda: gene_project_cuda(x, thr, gpd, gate=True))
    plain_ms = cuda_ms(lambda: gene_project_plain(x, thr, gpd, gate=True))
    out_gb = KERNEL_ROWS * gpd.total * 4 / 1e9
    log(f"K3 time (gated): kernel {ms:.3f} ms ({out_gb / ms:.3f} TB/s of output, {out_gb / ms * 1e3 / write_rate:.2%} "
        f"of the measured write rate), plain {plain_ms:.3f} ms (CUDA events around 10 calls in a row, median of 5 runs)")
    err = max(bench["ungated"], bench["gated"])
    del bench, x, thr

    var = synthetic_cnv_dataset(n_cells=8, n_genes=4000, seed=0).var
    var = var[~var["chromosome"].isin(["chrX", "chrY"])]
    splan = build_window_plan(var, 100, 10)
    syn = _k3_case(splan, KERNEL_ROWS, seed=4)
    assert (splan.n_windows, syn["gpd"].total, syn["gpd"].n_groups) == (180, 3658, 290)
    x, thr, sgpd = syn["x"], syn["thr"], syn["gpd"]
    syn_ms = cuda_ms(lambda: gene_project_cuda(x, thr, sgpd, gate=True))
    syn_plain_ms = cuda_ms(lambda: gene_project_plain(x, thr, sgpd, gate=True))
    log(f"K3 synthetic genome ({splan.n_windows} windows -> {sgpd.total} genes): ungated max |kernel - plain| "
        f"= {syn['ungated']:.3e}; gated agreement {syn['gate_agreement']:.6%}, max |diff| {syn['gated']:.3e}; "
        f"kernel {syn_ms:.3f} ms, plain {syn_plain_ms:.3f} ms")
    err = max(err, syn["ungated"], syn["gated"])
    del syn, x, thr
    _k3_edges(var)
    torch.cuda.empty_cache()
    return {
        "name": "gene_project", "route": "cuda", "source": "infercnvpy_tpu_torch/csrc/gene_project.cu",
        "replaces": "infercnvpy_tpu/ops/pallas_gene.py:127", "launches": None,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "ms_synthetic": syn_ms,
        "plain_ms_synthetic": syn_plain_ms, "library_ms": None,
        # windows and thresholds read once, gene columns written once, the group tables read once; the
        # group sums, the select's 4 passes and one subtraction and compare per group
        **bound(KERNEL_ROWS * (1793 + 1 + 19910) * 4 + (3 * 1991 + 19910) * 4,
                KERNEL_ROWS * (19910 + 1991 * (4 * 2 + 3))),
    }


def _bit_identical(got, want, what: str) -> None:
    import torch

    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        raise AssertionError(f"{what}: {bad} rows differ from the plain version")


def phase_select_kernels() -> list[dict]:
    import torch

    from infercnvpy_tpu_torch.genome import build_window_plan
    from infercnvpy_tpu_torch.ops.gene import gene_projection_data
    from infercnvpy_tpu_torch.ops.select import (
        row_kth_smallest_cuda,
        row_kth_smallest_plain,
        row_median_weighted_cuda,
        row_median_weighted_plain,
    )

    gpd = gene_projection_data(build_window_plan(make_var(N_GENES), 100, 10))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((KERNEL_ROWS, gpd.n_groups), dtype=np.float32)).cuda()
    # eighths: many equal keys, so the even total's lower middle is often the same key
    ties = torch.round(x * 8) / 8
    odd_w = gpd.g_counts.copy()
    odd_w[0] += 1
    k4 = {}
    for label, wts in (("even", gpd.g_counts), ("odd", odd_w)):
        wd = torch.from_numpy(wts).cuda()
        for vals in (x, ties):
            _bit_identical(row_median_weighted_cuda(vals, wd), row_median_weighted_plain(vals, wd),
                           f"K4 row_median_weighted ({KERNEL_ROWS}, {gpd.n_groups}), {label} total {int(wts.sum())}")
        k4[label] = (int(wts.sum()), cuda_ms(lambda: row_median_weighted_cuda(x, wd)),
                     cuda_ms(lambda: row_median_weighted_plain(x, wd)))
        log(f"K4 row_median_weighted ({KERNEL_ROWS}, {gpd.n_groups}), total {k4[label][0]}: bit-identical "
            f"(continuous and tied values); kernel {k4[label][1]:.3f} ms, plain {k4[label][2]:.3f} ms")
    del x, ties

    w = 1793
    x = torch.from_numpy(rng.standard_normal((KERNEL_ROWS, w), dtype=np.float32)).cuda()
    k5 = {}
    for k in (0, w // 2, w - 1):
        _bit_identical(row_kth_smallest_cuda(x, k), row_kth_smallest_plain(x, k),
                       f"K5 row_kth_smallest ({KERNEL_ROWS}, {w}), k={k}")
        # the one PyTorch call for the same function (1-based k): a yardstick, never called by the port
        _bit_identical(torch.kthvalue(x, k + 1, dim=1).values, row_kth_smallest_plain(x, k),
                       f"torch.kthvalue ({KERNEL_ROWS}, {w}), k={k}")
        k5[k] = (cuda_ms(lambda: row_kth_smallest_cuda(x, k)), cuda_ms(lambda: row_kth_smallest_plain(x, k)),
                 cuda_ms(lambda: torch.kthvalue(x, k + 1, dim=1)))
        log(f"K5 row_kth_smallest ({KERNEL_ROWS}, {w}), k={k}: bit-identical; kernel {k5[k][0]:.3f} ms, "
            f"plain {k5[k][1]:.3f} ms, torch.kthvalue {k5[k][2]:.3f} ms")
    del x
    return [
        {
            "name": "row_median_weighted", "route": "cuda", "source": "infercnvpy_tpu_torch/csrc/row_select.cu",
            "replaces": "infercnvpy_tpu/ops/pallas_select.py:154", "launches": None, "max_abs_err": 0.0,
            "ms": k4["even"][1], "plain_ms": k4["even"][2], "ms_odd_total": k4["odd"][1],
            "plain_ms_odd_total": k4["odd"][2], "library_ms": None,
            **bound(KERNEL_ROWS * (gpd.n_groups + 1) * 4 + gpd.n_groups * 4, KERNEL_ROWS * gpd.n_groups * 4 * 2),
        },
        {
            "name": "row_kth_smallest", "route": "cuda", "source": "infercnvpy_tpu_torch/csrc/row_select.cu",
            "replaces": "infercnvpy_tpu/ops/pallas_select.py:137", "launches": None, "max_abs_err": 0.0,
            "ms": k5[w // 2][0], "plain_ms": k5[w // 2][1],
            "ms_by_k": {str(k): v[0] for k, v in k5.items()}, "plain_ms_by_k": {str(k): v[1] for k, v in k5.items()},
            "library_ms": k5[w // 2][2], "library": "torch.kthvalue(x, k + 1, dim=1)",
            "library_ms_by_k": {str(k): v[2] for k, v in k5.items()},
            **bound(KERNEL_ROWS * (w + 1) * 4, KERNEL_ROWS * w * 4 * 2),
        },
    ]


def _kernel_wrappers() -> dict:
    """Each kernel's wrapper, by the name the report gives the kernel."""
    from infercnvpy_tpu_torch.ops.fused import fused_center_smooth_median_cuda
    from infercnvpy_tpu_torch.ops.gene import gene_project_cuda
    from infercnvpy_tpu_torch.ops.probe import write_probe_cuda
    from infercnvpy_tpu_torch.ops.select import row_kth_smallest_cuda, row_median_cuda, row_median_weighted_cuda

    return {
        "fused_window": fused_center_smooth_median_cuda, "gene_project": gene_project_cuda,
        "row_median": row_median_cuda, "row_median_weighted": row_median_weighted_cuda,
        "row_kth_smallest": row_kth_smallest_cuda, "write_probe": write_probe_cuda,
    }


def _reset_counts() -> None:
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _kernel_wrappers().items()}


def phase_gene_e2e() -> dict:
    import pandas as pd
    import torch

    import infercnvpy_tpu_torch as tcnv
    from infercnvpy_tpu_torch.genome import build_window_plan
    from infercnvpy_tpu_torch.ops.gene import gene_projection_data
    from infercnvpy_tpu_torch.tl._infercnv import _get_reference, _infercnv_compute, _reindex_genes

    t = time.perf_counter()
    var = make_var(N_GENES)
    expr = make_csr(GENE_CELLS, N_GENES, DENSITY)
    labels = np.array(["tumor"] * GENE_CELLS, dtype=object)
    labels[: N_NORMAL // 2] = "normal_a"
    labels[N_NORMAL // 2 : N_NORMAL] = "normal_b"
    obs = pd.DataFrame({"cell_type": pd.Categorical(labels)}, index=[f"cell_{i}" for i in range(GENE_CELLS)])
    adata = tcnv.AnnData(X=expr, obs=obs, var=var)
    cats = ["normal_a", "normal_b"]
    log(f"gene e2e input: {GENE_CELLS} x {N_GENES} CSR, nnz {expr.nnz:,}, made in {time.perf_counter() - t:.1f}s")

    plan = build_window_plan(var, 100, 10)
    gpd = gene_projection_data(plan)
    kw = dict(reference_key="cell_type", reference_cat=cats)
    tcnv.tl.infercnv(adata, calculate_gene_values=True, **kw)  # warm-up (allocator, caches)
    torch.cuda.synchronize()
    # tl.infercnv subsets the whole AnnData to the kept genes, layers included:
    # time that with the warm-up's layer present, then drop the layer so the
    # timed run starts as a first call does
    t = time.perf_counter()
    adata[:, np.ones(N_GENES, bool)]
    log(f"adata[:, keep] with a {GENE_CELLS} x {N_GENES} gene layer present: {time.perf_counter() - t:.3f}s")
    del adata.layers["gene_values_cnv"]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t = time.perf_counter()
    tcnv.tl.infercnv(adata, calculate_gene_values=True, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()

    n_batches = -(-GENE_CELLS // BATCH)
    if launches["gene_project"] != n_batches or launches["fused_window"] != n_batches:
        raise AssertionError(f"{launches} for {n_batches} batches: every batch must run fused_window and gene_project")
    genes = adata.layers["gene_values_cnv"]
    assert genes.shape == (GENE_CELLS, N_GENES) and genes.dtype == np.float32, (genes.shape, genes.dtype)
    covered = np.zeros(N_GENES, bool)
    covered[plan.used_genes[gpd.covered_sorted]] = True
    assert covered.sum() == gpd.total == 19910
    if not (np.isnan(genes[:, ~covered]).all() and np.isfinite(genes[:, covered]).all()):
        raise AssertionError("NaN columns of the gene matrix are not exactly the uncovered genes")
    log(f"gene e2e tl.infercnv(calculate_gene_values=True): {wall:.3f}s wall, {GENE_CELLS / wall:,.0f} cells/s, "
        f"layer {genes.shape} ({np.count_nonzero(genes[:, covered]) / (GENE_CELLS * gpd.total):.2%} nonzero), "
        f"launches {launches}, peak device memory {peak / 2**30:.3f} GiB")

    plain = tcnv.AnnData(X=expr, obs=obs, var=var)
    tcnv.tl.infercnv(plain, **kw)
    torch.cuda.synchronize()
    if not _csr_equal(adata.obsm["X_cnv"], plain.obsm["X_cnv"]):
        raise AssertionError("X_cnv with calculate_gene_values=True differs from the run without it")
    log(f"X_cnv with gene values is bit-identical to the run without (nnz {plain.obsm['X_cnv'].nnz:,})")

    reference = _get_reference(adata, "cell_type", cats, None, None)
    sub = adata[:5000]
    _, _, g = tcnv.tl.infercnv(sub, reference=reference, device="cuda", inplace=False, calculate_gene_values=True)
    _, _, c = tcnv.tl.infercnv(sub, reference=reference, device="cpu", inplace=False, calculate_gene_values=True)
    if not np.array_equal(np.isnan(g), np.isnan(c)):
        raise AssertionError("chunk 0 gene values: NaN pattern differs between GPU and CPU")
    g, c = g[:, covered], c[:, covered]
    same_gate = float(((g != 0) == (c != 0)).mean())
    both = (g != 0) & (c != 0)
    err = float(np.abs(g[both] - c[both]).max()) if both.any() else 0.0
    log(f"gene chunk 0 (5000 cells) GPU vs CPU: gate agrees on {same_gate:.6%} of entries, "
        f"max |diff| where both nonzero {err:.3e}")
    if same_gate < 0.9999:
        raise AssertionError(f"gene gate pattern agrees on only {same_gate:.6%} of entries")
    np.testing.assert_allclose(g[both], c[both], rtol=1e-4, atol=1e-5)
    del g, c, sub, plain

    stats: dict = {}
    masked = var[["chromosome", "start", "end"]]
    _, _, per_gene = _infercnv_compute(
        expr, masked, reference, lfc_clip=3, window_size=100, step=10, dynamic_threshold=1.5, chunksize=5000,
        batch_cells=None, dtype=None, device=torch.device("cuda"), stats=stats, progress=False,
        calculate_gene_values=True,
    )
    _reindex_genes(per_gene, obs.index, masked.index, var.index, stats)
    log("gene e2e stats run: " + json.dumps({k: (round(v, 6) if isinstance(v, float) else v) for k, v in stats.items()}))
    del per_gene

    # checkpoint: lose the second of the two batch files, resume
    with tempfile.TemporaryDirectory() as td:
        _, res1, g1 = tcnv.tl.infercnv(adata, checkpoint_dir=td, inplace=False, calculate_gene_values=True, **kw)
        files = sorted(Path(td).glob("batch_*.npz"))
        if len(files) != n_batches:
            raise AssertionError(f"{len(files)} batch files for {n_batches} batches")
        files[-1].unlink()
        _reset_counts()
        _, res2, g2 = tcnv.tl.infercnv(adata, checkpoint_dir=td, inplace=False, calculate_gene_values=True, **kw)
        resumed = _read_counts()
        if resumed["gene_project"] != 1 or resumed["fused_window"] != 1:
            raise AssertionError(f"{resumed}: the resume of 1 of 2 batches must launch each kernel once")
        for what, g in (("checkpointed", g1), ("resumed", g2)):
            if not np.array_equal(g.view(np.uint32), genes.view(np.uint32)):
                raise AssertionError(f"the {what} gene layer differs from the run without checkpoint_dir")
        if not (_csr_equal(res1, adata.obsm["X_cnv"]) and _csr_equal(res2, adata.obsm["X_cnv"])):
            raise AssertionError("X_cnv of the checkpointed gene run differs")
        _expect_config_mismatch(lambda: tcnv.tl.infercnv(adata, checkpoint_dir=td, inplace=False, lfc_clip=2.5,
                                                         calculate_gene_values=True, **kw))
    log(f"gene checkpoint: resume of 1 of {n_batches} batches launched {resumed}, gene layer and X_cnv bit-identical")
    return {"launches": launches, "wall": wall}


def main() -> int:
    import torch

    smi, kind = phase_device()
    phase_build()
    kernels = phase_kernels()
    probe = phase_probe(kernels[0])
    e2e = phase_e2e()
    phase_pipeline(e2e)
    phase_bf16(e2e)
    phase_checkpoint(e2e)
    phase_parity(e2e["adata"], e2e["reference"])
    e2e_launches = e2e["launches"]
    del e2e
    gene_kernel = phase_gene_kernels(probe["write_gb_per_s"])
    selects = phase_select_kernels()
    gene_e2e = phase_gene_e2e()
    # each path's kernels take their launches from that path's run
    kernels[0]["launches"] = e2e_launches["fused_window"]
    gene_kernel["launches"] = gene_e2e["launches"]["gene_project"]
    on_path = [kernels[0], gene_kernel]
    off_path = [kernels[1], *selects]
    for k in off_path:
        k["launches"] = e2e_launches[k["name"]] + gene_e2e["launches"][k["name"]]
    for k in [*on_path, *off_path, probe]:
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    print(smi)
    # row_median, row_median_weighted and row_kth_smallest are ported and
    # checked, but the paths run their select inside fused_window and
    # gene_project, so they are reported apart from the paths' kernels; the
    # write probe has a path of its own (write_bandwidth), whose launches it
    # reports
    print(json.dumps({"kernels": on_path, "kernels_off_main_path": [*off_path, probe]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
