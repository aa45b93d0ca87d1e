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
9. downstream — (a) quality at a size with known answers: the synthetic
              20,000 × 4,000 dataset (chr1 / chr19 / chr20 events in 60 %
              malignant cells) through ``tl.infercnv`` → ``tl.pca`` →
              ``pp.neighbors`` → ``tl.leiden`` → ``tl.cnv_score`` →
              ``tl.ithcna`` → ``tl.ithgex`` → ``tl.umap`` → ``tl.tsne`` on
              the card: cluster purity, the malignant / normal ``cnv_score``
              ratio, PCA / kNN / connectivities / Leiden against the port's
              CPU path, layouts finite, bit-identical on rerun and separating
              the classes, products unchanged with TF32 switched on globally,
              the Leiden library built from ``native/leiden.cpp`` at first
              use; (b) walls at scale: the 102,400-cell run's ``X_cnv``
              through ``tl.pca`` → ``pp.neighbors`` → ``tl.leiden`` →
              ``tl.cnv_score`` → ``tl.umap``, each stage's wall, peak device
              memory, the device idle share of one traced run, and
              ``tl.tsne``'s ``max_cells`` refusal
11. annotate and plot — the path of a user with real data, after phase 9:
              (a) a GENCODE-style gzipped GTF of >= 1,000,000 lines (the
              20,000 genes of phase 4 and 40,000 others, each with 2
              transcripts of 7 exons) written from a seed; (b)
              ``io.genomic_position_from_gtf`` on phase 4's ``X`` and
              ``obs`` with a bare ``var``: every gene annotated, positions
              equal to phase 4's; (c) ``tl.infercnv`` on it: 7
              ``fused_window`` launches, ``X_cnv`` and ``chr_pos``
              bit-identical to phase 4's; (d) where matplotlib is installed
              (decided once, with one line saying so), on Agg: the
              102,400-cell ``pl.chromosome_heatmap`` (image = ``X_cnv`` in
              group order, chromosome tick labels, PNG written),
              ``pl.chromosome_heatmap_summary`` and ``pl.umap``, with no
              figure left open; (e) the summary of phase 9a's synthetic
              cells: chr1 loss and chr19 / chr20 gain in the malignant row;
              (f) a JSON line of walls and the GTF's size
12. multi-device — one card, several cell shards and processes: (a)
              ``tl.infercnv(device=["cuda:0", "cuda:0"])`` on phase 4's
              CSR (two ``fused_window`` launches a batch, ``X_cnv`` and
              ``chr_pos`` bit-identical to phase 4's) and with gene values
              on phase 8's (two of each kernel a batch, the gene layer
              bit-identical to phase 8's), beside a one-device run with the
              same host packer; (b) two gloo ranks on the card, each with
              half of phase 4's cells, through
              ``parallel.distributed.infercnv_distributed``, and (c) one
              NCCL rank (world size 1) on phase 4's first 15,000 cells, all
              spawned at once as children of this script, each with a
              timeout: every rank's rows bit-identical to phase 4's; (d) on
              phase 9a's synthetic cells ``tl.pca`` / ``pp.neighbors`` /
              ``tl.cnv_score`` / ``tl.ithcna`` on two shards against the
              card alone (kNN equal, PCA sigma at rtol 1e-6, scores at 1e-9
              relative); (e) a JSON line of the walls beside one device's
10. report  — the card line, a JSON line of kernel numbers (each kernel
              with its bytes, its bound on an H100 from those bytes and
              operations, its share of the bound and, where one PyTorch call
              computes the same function, that call's time), then
              ``{"ok": true, "device": {...}}`` as the last line

It imports nothing of JAX and nothing of ``infercnvpy_tpu``.  Phase 12's
ranks run this file as ``python3 chip_smoke.py --rank-child ...``.
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
DOWNSTREAM_CELLS = 20_000
DOWNSTREAM_GENES = 4_000
SYNTHETIC_CATS = ["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"]
GTF_EXTRA_GENES = 40_000  # GENCODE's ~60,000 human genes, with the 20,000 of the AnnData
GTF_TRANSCRIPTS, GTF_EXONS = 2, 7  # lines per gene: 1 + 2 × (1 + 7) = 17
GTF_MIN_LINES = 1_000_000
TWO_SHARDS = ["cuda:0", "cuda:0"]
RANK_TIMEOUT = 300  # seconds a spawned rank may take before the phase fails
NCCL_CELLS = 15_000  # the one NCCL rank's cells: phase 4's first batch


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


T0 = time.perf_counter()


# hg38 autosome lengths (Mb)
CHR_MB = np.array([248, 242, 198, 190, 181, 171, 159, 145, 138, 134, 135, 133,
                   114, 107, 102, 90, 83, 80, 59, 64, 47, 51], dtype=float)


def make_var(n_genes: int, seed: int = 0):
    """Genome of the benchmark: 22 autosomes, genes proportional to chromosome length."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    counts = np.maximum(1, (CHR_MB / CHR_MB.sum() * n_genes)).astype(int)
    counts[0] += n_genes - counts.sum()
    rows = []
    for c, k in enumerate(counts):
        starts = np.sort(rng.integers(1, int(CHR_MB[c] * 1e6), size=k))
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
    spans, kernel_us, fused_us, by_name = [], 0.0, 0.0, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))))
        name = e.get("name", "")
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + float(e.get("dur", 0.0)) / 1e6
        if e["cat"] == "kernel":
            kernel_us += float(e.get("dur", 0.0))
            if "fused_window" in name:
                fused_us += float(e.get("dur", 0.0))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans:
        raise AssertionError(f"the trace {path} holds no device activity")
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    return {"busy_sec": busy / 1e6, "kernel_sec": kernel_us / 1e6, "fused_window_sec": fused_us / 1e6,
            "idle_share": 1.0 - busy / 1e6 / wall, "n_device_events": len(spans), "top_device_sec": top}


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


def _ari(a, b) -> float:
    """Adjusted Rand index of two labelings, in numpy."""
    _, ia = np.unique(np.asarray(a), return_inverse=True)
    _, ib = np.unique(np.asarray(b), return_inverse=True)
    table = np.zeros((ia.max() + 1, ib.max() + 1), dtype=np.int64)
    np.add.at(table, (ia, ib), 1)

    def pairs(x):
        x = np.asarray(x, dtype=np.float64)
        return float((x * (x - 1) / 2).sum())

    sum_c, sum_a, sum_b = pairs(table), pairs(table.sum(axis=1)), pairs(table.sum(axis=0))
    expected = sum_a * sum_b / pairs([len(ia)])
    return (sum_c - expected) / ((sum_a + sum_b) / 2 - expected)


def _purity(labels, malignant) -> dict:
    """Each Leiden cluster of >= 50 cells: the share of its commoner class."""
    labels, out = np.asarray(labels), {}
    for label in np.unique(labels):
        member = labels == label
        if member.sum() >= 50:
            share = float(malignant[member].mean())
            out[str(label)] = max(share, 1.0 - share)
    return out


def _cluster_class(labels, malignant) -> np.ndarray:
    """For each cell, whether its cluster is mostly malignant."""
    labels = np.asarray(labels)
    out = np.empty(len(labels), bool)
    for label in np.unique(labels):
        member = labels == label
        out[member] = malignant[member].mean() >= 0.5
    return out


def _separation(emb: np.ndarray, labels: np.ndarray) -> float:
    """Mean distance between class centroids over mean distance to the own centroid (tests/test_downstream.py)."""
    classes = np.unique(labels)
    cents = np.stack([emb[labels == c].mean(0) for c in classes])
    m = len(classes)
    inter = np.linalg.norm(cents[:, None] - cents[None, :], axis=-1).sum() / (m * (m - 1))
    intra = np.mean([np.linalg.norm(emb[labels == c] - cents[i], axis=1).mean() for i, c in enumerate(classes)])
    return float(inter / intra)


def _timed(fn) -> float:
    return _timed_result(fn)[0]


def _timed_result(fn) -> tuple:
    """``(wall seconds, fn())``, the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _leiden_library_check(loaded_before: bool) -> str:
    """The Leiden library was loaded at first use, from the build of this checkout's ``native/leiden.cpp``."""
    import hashlib

    from infercnvpy_tpu_torch import native

    if loaded_before:
        raise AssertionError("the Leiden library was loaded before the first tl.leiden call")
    if native._LEIDEN_LIB is None:
        raise AssertionError("tl.leiden ran without loading the native Leiden library")
    src = Path(native.__file__).resolve().parent / "leiden.cpp"
    tag = hashlib.sha256(repr(native.LEIDEN_FLAGS).encode() + src.read_bytes()).hexdigest()[:16]
    want = native.BUILD_DIR / f"libinfercnv_leiden-{tag}.so"
    if Path(native._LEIDEN_LIB._name) != want or not want.exists():
        raise AssertionError(f"the Leiden library {native._LEIDEN_LIB._name} is not the build of {src} ({want})")
    return want.name


def _tf32_check(scores: np.ndarray, X_cnv) -> None:
    """The slice's float32 products give the same bits with TF32 switched on globally: the port holds it off."""
    import torch

    from infercnvpy_tpu_torch.ops.knn import exact_knn
    from infercnvpy_tpu_torch.ops.linalg import truncated_svd

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for float32 products before the downstream phase")
    off = exact_knn(scores, 15, device="cuda"), truncated_svd(X_cnv, 50, device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = exact_knn(scores, 15, device="cuda"), truncated_svd(X_cnv, 50, device="cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for a, b in zip([*off[0], *off[1]], [*on[0], *on[1]]):
        if not _bits_equal(a, b):
            raise AssertionError("exact_knn / truncated_svd changed with TF32 switched on globally")
    log("TF32: off for every float32 product of the slice (exact_knn and truncated_svd bit-identical with the "
        "global flag on)")


def phase_downstream_quality() -> dict:
    """The downstream workflow on the card at a size with known answers, against the port's CPU path."""
    import torch

    import infercnvpy_tpu_torch as tcnv
    from infercnvpy_tpu_torch import native
    from infercnvpy_tpu_torch.ops.graph import fuzzy_connectivities
    from infercnvpy_tpu_torch.ops.knn import exact_knn
    from infercnvpy_tpu_torch.ops.linalg import truncated_svd

    t = time.perf_counter()
    adata = tcnv.datasets.synthetic_cnv_dataset(n_cells=DOWNSTREAM_CELLS, n_genes=DOWNSTREAM_GENES, seed=0)
    malignant = (adata.obs["cell_type"] == "Malignant").values
    log(f"downstream input: synthetic {DOWNSTREAM_CELLS} x {DOWNSTREAM_GENES}, {malignant.mean():.0%} malignant, "
        f"made in {time.perf_counter() - t:.1f}s")

    walls = {}
    _reset_counts()
    walls["infercnv"] = _timed(lambda: tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=SYNTHETIC_CATS))
    leiden_loaded = native._LEIDEN_LIB is not None
    torch.cuda.reset_peak_memory_stats()
    walls["pca"] = _timed(lambda: tcnv.tl.pca(adata))
    walls["neighbors"] = _timed(lambda: tcnv.pp.neighbors(adata))
    walls["leiden"] = _timed(lambda: tcnv.tl.leiden(adata))
    lib = _leiden_library_check(leiden_loaded)
    walls["cnv_score"] = _timed(lambda: tcnv.tl.cnv_score(adata))
    walls["ithcna"] = _timed(lambda: tcnv.tl.ithcna(adata, "cnv_leiden"))
    walls["ithgex"] = _timed(lambda: tcnv.tl.ithgex(adata, "cnv_leiden"))
    walls["umap"] = _timed(lambda: tcnv.tl.umap(adata))
    walls["tsne"] = _timed(lambda: tcnv.tl.tsne(adata))
    peak = torch.cuda.max_memory_allocated()
    launches = _read_counts()
    if launches["fused_window"] < 1:
        raise AssertionError("the downstream path on the card did not launch fused_window")
    log(f"downstream walls at {DOWNSTREAM_CELLS:,} cells (s): " + json.dumps({k: round(v, 4) for k, v in walls.items()})
        + f"; peak device memory after tl.infercnv {peak / 2**30:.3f} GiB; the path launched {launches}; "
        f"Leiden library {lib}, loaded at first use")

    labels = adata.obs["cnv_leiden"].values
    sizes = adata.obs["cnv_leiden"].value_counts()
    purity = _purity(labels, malignant)
    worst = min(purity.values())
    if worst < 0.95:
        raise AssertionError(f"a Leiden cluster of >= 50 cells is only {worst:.2%} one class: {purity}")
    score = adata.obs["cnv_score"].values
    ratio = float(score[malignant].mean() / score[~malignant].mean())
    if ratio < 3.0:
        raise AssertionError(f"malignant / normal mean cnv_score {ratio:.2f} < 3")
    ith = adata.obs.groupby("cnv_leiden", observed=True)[["ithcna", "ithgex"]].first()
    if not (np.isfinite(ith["ithgex"]).any() and np.isfinite(ith["ithcna"]).any()):
        raise AssertionError("no finite ithcna / ithgex score")
    log(f"{len(sizes)} Leiden clusters, {len(purity)} of >= 50 cells, each >= {worst:.2%} one class; malignant / "
        f"normal mean cnv_score {ratio:.2f}; ithcna / ithgex finite in {int(np.isfinite(ith['ithcna']).sum())} / "
        f"{int(np.isfinite(ith['ithgex']).sum())} of {len(ith)} clusters")

    # the card against the port's CPU path on the same X_cnv, stage by stage
    X_cnv, scores = adata.obsm["X_cnv"], adata.obsm["X_cnv_pca"]
    n = X_cnv.shape[0]
    sv_card = np.sqrt(adata.uns["cnv_pca"]["variance"] * (n - 1))
    scores_cpu, _, sv_cpu = truncated_svd(X_cnv, scores.shape[1], device="cpu")
    np.testing.assert_allclose(sv_card, sv_cpu, rtol=1e-4)
    sv_err = float(np.max(np.abs(sv_card - sv_cpu) / sv_cpu))
    # each component's sign is arbitrary: align, then hold each column's relative L2 error
    sign = np.where(np.sum(scores * scores_cpu, axis=0) < 0, -1.0, 1.0)
    score_err = float(np.max(np.linalg.norm(scores * sign - scores_cpu, axis=0) / np.linalg.norm(scores_cpu, axis=0)))
    if score_err > 1e-4:
        raise AssertionError(f"PCA scores: a component differs from the CPU's by {score_err:.2e} (relative L2) > 1e-4")
    k = adata.uns["cnv_neighbors"]["params"]["n_neighbors"]
    d_card, i_card = exact_knn(scores, k, device="cuda")
    d_cpu, i_cpu = exact_knn(scores, k + 1, device="cpu")
    d_err = float(np.abs(np.sort(d_card, axis=1) - d_cpu[:, :k]).max())
    tied = np.abs(d_cpu[:, k] - d_cpu[:, k - 1]) <= 1e-5 * np.maximum(1.0, d_cpu[:, k])
    same = np.fromiter((set(i_card[r]) == set(i_cpu[r, :k]) for r in range(n)), bool, count=n)
    agree = float(same[~tied].mean())
    if agree < 0.999:
        raise AssertionError(f"neighbour sets agree on only {agree:.4%} of the untied rows")
    # the graph stage on the same kNN arrays (the card's), on the card and on the CPU
    c_card = fuzzy_connectivities(d_card, i_card, device="cuda")
    c_cpu = fuzzy_connectivities(d_card, i_card, device="cpu")
    if not (np.array_equal(c_card.indptr, c_cpu.indptr) and np.array_equal(c_card.indices, c_cpu.indices)):
        raise AssertionError("connectivities from the same kNN arrays: the card's pattern differs from the CPU's")
    np.testing.assert_allclose(c_card.data, c_cpu.data, rtol=1e-4)
    nz = c_cpu.data != 0
    conn_err = float(np.max(np.abs(c_card.data[nz] - c_cpu.data[nz]) / np.abs(c_cpu.data[nz])))
    # Leiden on the whole CPU path's graph (its own PCA, kNN and graph) against the card's labels.
    # At resolution 1.0 each class splits into some 20-30 clusters along no planted structure, and
    # graphs that differ in rounding move those splits, on untied rows as much as on tied ones, so
    # the labels agree well short of ARI 1 (PERF.md, section 6). Held: the class each cluster
    # stands for, cell by cell, and ARI over a bar below the H100 reading.
    on_cpu = tcnv.AnnData(X=adata.X, obs=adata.obs[["cell_type"]].copy(), var=adata.var)
    on_cpu.obsm["X_cnv"] = X_cnv
    tcnv.tl.pca(on_cpu, device="cpu")
    tcnv.pp.neighbors(on_cpu, device="cpu")
    tcnv.tl.leiden(on_cpu)
    cpu_labels = on_cpu.obs["cnv_leiden"].values
    cpu_purity = min(_purity(cpu_labels, malignant).values())
    if cpu_purity < 0.95:
        raise AssertionError(f"a Leiden cluster of >= 50 cells on the CPU path is only {cpu_purity:.2%} one class")
    class_agree = float((_cluster_class(labels, malignant) == _cluster_class(cpu_labels, malignant)).mean())
    if class_agree < 0.999:
        raise AssertionError(f"card and CPU Leiden clusters stand for the same class on only {class_agree:.4%} of cells")
    ari = _ari(labels, cpu_labels)
    ari_untied = _ari(np.asarray(labels)[~tied], np.asarray(cpu_labels)[~tied])
    if ari < 0.8:
        raise AssertionError(f"Leiden on the card's graph vs on the CPU path's graph: ARI {ari:.4f} < 0.8")
    log(f"card vs CPU: PCA singular values max rel diff {sv_err:.2e} (bar 1e-4), scores max rel L2 diff per "
        f"component {score_err:.2e} (bar 1e-4); neighbour sets equal on {agree:.4%} of {int((~tied).sum())} untied "
        f"rows ({int(tied.sum())} rows tied at the k-th neighbour), sorted distances max |diff| {d_err:.2e}; "
        f"connectivities from the same kNN arrays: same pattern ({c_card.nnz:,} entries), max rel diff "
        f"{conn_err:.2e} (bar 1e-4); Leiden on the whole CPU path: {len(np.unique(cpu_labels))} clusters, each "
        f">= {cpu_purity:.2%} one class, cluster class equal to the card's on {class_agree:.4%} of cells (bar "
        f"99.9 %), ARI {ari:.4f} (bar 0.8), {ari_untied:.4f} on the untied rows")
    _tf32_check(scores, X_cnv)

    layouts = {}
    for key, rerun in (("X_cnv_umap", lambda: tcnv.tl.umap(adata, inplace=False)),
                       ("X_cnv_tsne", lambda: tcnv.tl.tsne(adata, inplace=False))):
        emb = adata.obsm[key]
        if emb.shape != (n, 2) or not np.isfinite(emb).all():
            raise AssertionError(f"{key}: shape {emb.shape}, finite {np.isfinite(emb).all()}")
        if not _bits_equal(np.asarray(rerun()), emb):
            raise AssertionError(f"{key}: a rerun with the same seed gave other bits")
        layouts[key] = _separation(emb, malignant)
        if layouts[key] <= 2.0:
            raise AssertionError(f"{key}: malignant vs normal separation {layouts[key]:.2f} <= 2")
    log("layouts finite and bit-identical on rerun; malignant vs normal separation " + json.dumps(
        {k: round(v, 3) for k, v in layouts.items()}))
    torch.cuda.empty_cache()
    return {"walls": walls, "peak_bytes": peak, "launches": launches, "purity_min": worst, "score_ratio": ratio,
            "ari": ari, "class_agree": class_agree, "knn_agree": agree, "separation": layouts, "adata": adata}


def _downstream_chain(adata) -> dict:
    import infercnvpy_tpu_torch as tcnv

    return {
        "pca": _timed(lambda: tcnv.tl.pca(adata, n_comps=50)),
        "neighbors": _timed(lambda: tcnv.pp.neighbors(adata, n_neighbors=15)),
        "leiden": _timed(lambda: tcnv.tl.leiden(adata)),
        "cnv_score": _timed(lambda: tcnv.tl.cnv_score(adata)),
        "umap": _timed(lambda: tcnv.tl.umap(adata)),
    }


def phase_downstream_scale(adata) -> dict:
    """The 102,400-cell run's X_cnv through the downstream chain: walls, peak memory, idle share."""
    import torch

    import infercnvpy_tpu_torch as tcnv
    from infercnvpy_tpu_torch import profiling

    sub = tcnv.AnnData(X=adata.X, obs=adata.obs[["cell_type"]].copy(), var=adata.var)
    sub.obsm["X_cnv"] = adata.obsm["X_cnv"]
    sub.uns["cnv"] = adata.uns["cnv"]
    torch.cuda.reset_peak_memory_stats()
    walls = _downstream_chain(sub)
    peak = torch.cuda.max_memory_allocated()
    emb = sub.obsm["X_cnv_umap"]
    if emb.shape != (N_CELLS, 2) or not np.isfinite(emb).all():
        raise AssertionError(f"X_cnv_umap at {N_CELLS} cells: shape {emb.shape}")
    n_clusters = len(sub.obs["cnv_leiden"].cat.categories)
    log(f"downstream walls at {N_CELLS} cells (s): " + json.dumps({k: round(v, 4) for k, v in walls.items()})
        + f", total {sum(walls.values()):.3f}; peak device memory {peak / 2**30:.3f} GiB; "
        f"{n_clusters} Leiden clusters, largest {int(sub.obs['cnv_leiden'].value_counts().iloc[0]):,} cells")
    with tempfile.TemporaryDirectory() as td:
        with profiling.trace(td):
            t = time.perf_counter()
            traced = _downstream_chain(sub)
            wall = time.perf_counter() - t
        summary = _trace_summary(Path(td) / profiling.TRACE_FILE, wall)
    log(f"traced downstream chain: {wall:.3f}s wall (" + json.dumps({k: round(v, 4) for k, v in traced.items()})
        + f"), device busy {summary['busy_sec']:.6f}s (kernels {summary['kernel_sec']:.6f}s), "
        f"device idle {summary['idle_share']:.2%}; most device time: "
        + json.dumps({k: round(v, 6) for k, v in summary["top_device_sec"].items()}))
    try:
        tcnv.tl.tsne(sub)
    except ValueError as e:
        if "max_cells" not in str(e):
            raise
        log(f"tl.tsne at {N_CELLS} cells refused: {e}")
    else:
        raise AssertionError(f"tl.tsne ran at {N_CELLS} cells instead of refusing above max_cells")
    torch.cuda.empty_cache()
    return {"walls": walls, "peak_bytes": peak, "traced_wall": wall, **summary, "adata": sub}


def write_gtf(path: Path, var, n_extra: int, seed: int = 11) -> int:
    """A gzipped GENCODE-style GTF: ``var``'s genes at their positions and ``n_extra`` others, in genome order.

    Each gene record (``gene_name`` its ``var`` name, a versioned ``gene_id``)
    is followed by its transcripts and their exons. Returns the line count.
    """
    import gzip

    import pandas as pd

    rng = np.random.default_rng(seed)
    chrom = rng.choice(len(CHR_MB), size=n_extra, p=CHR_MB / CHR_MB.sum())
    start = (rng.random(n_extra) * CHR_MB[chrom] * 1e6).astype(np.int64) + 1
    extra = pd.DataFrame({"chromosome": [f"chr{c + 1}" for c in chrom], "start": start,
                          "end": start + rng.integers(500, 200_000, size=n_extra)},
                         index=[f"novel_{j}" for j in range(n_extra)])
    genes = pd.concat([var[["chromosome", "start", "end"]], extra])
    genes["num"] = genes["chromosome"].str.slice(3).astype(int)
    genes = genes.sort_values(["num", "start"], kind="stable")
    version = rng.integers(1, 20, size=len(genes))
    strand = np.where(rng.random(len(genes)) < 0.5, "+", "-")
    lines = ["##description: evidence-based annotation of the human genome, made from a seed\n",
             "##provider: GENCODE\n", "##format: gtf\n"]
    for k, (name, c, s, e) in enumerate(zip(genes.index, genes["chromosome"], genes["start"], genes["end"])):
        head = f"{c}\tHAVANA\t"
        tail = f"\t.\t{strand[k]}\t.\tgene_id \"ENSG{k:011d}.{version[k]}\"; gene_type \"protein_coding\"; "
        lines.append(f"{head}gene\t{s}\t{e}{tail}gene_name \"{name}\"; level 2;\n")
        step = max(1, (e - s) // GTF_EXONS)
        for tr in range(GTF_TRANSCRIPTS):
            tid = f"transcript_id \"ENST{k * GTF_TRANSCRIPTS + tr:011d}.1\"; "
            lines.append(f"{head}transcript\t{s}\t{e}{tail}{tid}gene_name \"{name}\"; level 2;\n")
            for x in range(GTF_EXONS):
                a = s + x * step
                lines.append(f"{head}exon\t{a}\t{min(e, a + step // 2)}{tail}{tid}gene_name \"{name}\"; "
                             f"exon_number {x + 1}; level 2;\n")
    with gzip.open(path, "wt", compresslevel=1) as fh:
        fh.write("".join(lines))
    return len(lines)


def _plots(big, synthetic, figdir: Path) -> dict:
    """The 102,400-cell heatmap, summary and UMAP plots, then the synthetic summary's CNV signal."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    import infercnvpy_tpu_torch as tcnv

    prev, tcnv.settings.figdir = tcnv.settings.figdir, figdir
    walls = {}
    t = time.perf_counter()
    try:
        axes = tcnv.pl.chromosome_heatmap(big, groupby="cnv_leiden", show=False, save=".png")
    finally:
        tcnv.settings.figdir = prev
    walls["heatmap"] = time.perf_counter() - t
    image = np.ma.getdata(axes["heatmap_ax"].images[0].get_array())
    order = np.argsort(big.obs["cnv_leiden"].cat.codes.to_numpy(), kind="stable")
    if not _bits_equal(image, big.obsm["X_cnv"][order].toarray()):
        raise AssertionError("the heatmap's image is not X_cnv's rows in the cnv_leiden order")
    ticks = [label.get_text() for label in axes["heatmap_ax"].get_xticklabels()]
    if ticks != list(big.uns["cnv"]["chr_pos"]):
        raise AssertionError(f"heatmap tick labels {ticks} are not the chromosomes of chr_pos")
    png = figdir / "heatmap.png"
    if not (png.exists() and png.stat().st_size > 0):
        raise AssertionError(f"{png} was not written")
    del axes, image
    t = time.perf_counter()
    tcnv.pl.chromosome_heatmap_summary(big, groupby="cnv_leiden", show=False)
    walls["summary"] = time.perf_counter() - t
    t = time.perf_counter()
    tcnv.pl.umap(big, color="cnv_leiden", show=False)
    walls["umap"] = time.perf_counter() - t
    if plt.get_fignums():
        raise AssertionError(f"figures left open after the plots: {plt.get_fignums()}")

    # the synthetic data's planted events in the summary: chr1 loss, chr19 / chr20 gain in the malignant row
    axes = tcnv.pl.chromosome_heatmap_summary(synthetic, groupby="cell_type", show=False)
    M = np.ma.getdata(axes["heatmap_ax"].images[0].get_array())
    rows = [text.get_text() for text in axes["groupby_ax"].texts]
    chr_pos = synthetic.uns["cnv"]["chr_pos"]
    names, starts = list(chr_pos), list(chr_pos.values()) + [M.shape[1]]
    signal = {}
    for chrom, sign in (("chr1", -1), ("chr19", 1), ("chr20", 1)):
        i = names.index(chrom)
        means = {g: float(M[r, starts[i] : starts[i + 1]].mean()) for r, g in enumerate(rows)}
        mal = means.pop("Malignant")
        if not (sign * mal > 0 and all(abs(mal) > abs(v) for v in means.values())):
            raise AssertionError(f"{chrom}: malignant mean {mal:.4f} against the normal rows {means}")
        signal[chrom] = {"Malignant": mal, **means}
    if plt.get_fignums():
        raise AssertionError(f"figures left open after the synthetic summary: {plt.get_fignums()}")
    log(f"plots at {big.n_obs:,} cells: heatmap image = X_cnv in group order, {len(ticks)} chromosome ticks, "
        f"{png.name} {png.stat().st_size:,} B; no figure left open; synthetic summary: " + json.dumps(
            {c: {g: round(v, 4) for g, v in m.items()} for c, m in signal.items()}))
    return walls


def phase_annotate_and_plot(e2e: dict, synthetic, big) -> None:
    """GTF → ``io.genomic_position_from_gtf`` → ``tl.infercnv`` on the card → the ``pl`` plots, at full size."""
    import importlib.util

    import pandas as pd
    import torch

    import infercnvpy_tpu_torch as tcnv
    from infercnvpy_tpu_torch.io import _genepos

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    log("matplotlib " + ("is installed: the plots run" if has_mpl else
                         "is not installed on this machine: the GTF and tl.infercnv parts run, the plots do not"))
    var = make_var(N_GENES)
    report: dict = {}
    with tempfile.TemporaryDirectory() as td:
        gtf = Path(td) / "gencode.annotation.gtf.gz"
        t = time.perf_counter()
        report["gtf_lines"] = write_gtf(gtf, var, GTF_EXTRA_GENES)
        report["gtf_write_sec"] = time.perf_counter() - t
        report["gtf_bytes"] = gtf.stat().st_size
        if report["gtf_lines"] < GTF_MIN_LINES:
            raise AssertionError(f"the GTF has {report['gtf_lines']:,} lines < {GTF_MIN_LINES:,}")

        obs = e2e["adata"].obs[["cell_type"]].copy()
        adata = tcnv.AnnData(X=e2e["expr"], obs=obs, var=pd.DataFrame(index=var.index.copy()))
        read_gtf, spent = _genepos.read_gtf, []

        def timed_read_gtf(*args, **kwargs):
            t = time.perf_counter()
            out = read_gtf(*args, **kwargs)
            spent.append(time.perf_counter() - t)
            return out

        _genepos.read_gtf = timed_read_gtf
        try:
            t = time.perf_counter()
            tcnv.io.genomic_position_from_gtf(gtf, adata)
            report["annotate_sec"] = time.perf_counter() - t
        finally:
            _genepos.read_gtf = read_gtf
        report["read_gtf_sec"] = spent[0]
    got = adata.var[["chromosome", "start", "end"]]
    if int(got.isna().to_numpy().sum()):
        raise AssertionError(f"{int(got.isna().any(axis=1).sum())} genes left unannotated")
    for col in ("chromosome", "start", "end"):
        if got[col].tolist() != var[col].tolist():
            raise AssertionError(f"var[{col!r}] from the GTF differs from phase 4's")
    log(f"GTF: {report['gtf_lines']:,} lines, {report['gtf_bytes']:,} B gzipped, written in "
        f"{report['gtf_write_sec']:.3f}s; genomic_position_from_gtf {report['annotate_sec']:.3f}s (read_gtf "
        f"{report['read_gtf_sec']:.3f}s): {len(got):,} genes annotated, positions equal to phase 4's")

    _reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    tcnv.tl.infercnv(adata, reference=e2e["reference"], **E2E_KW)
    torch.cuda.synchronize()
    report["infercnv_sec"] = time.perf_counter() - t
    launches = _read_counts()
    n_batches = -(-N_CELLS // BATCH)
    if launches["fused_window"] != n_batches:
        raise AssertionError(f"fused_window ran {launches['fused_window']} times for {n_batches} batches")
    if not _csr_equal(adata.obsm["X_cnv"], e2e["adata"].obsm["X_cnv"]):
        raise AssertionError("X_cnv on the GTF-annotated AnnData differs from phase 4's")
    if adata.uns["cnv"]["chr_pos"] != e2e["adata"].uns["cnv"]["chr_pos"]:
        raise AssertionError("chr_pos on the GTF-annotated AnnData differs from phase 4's")
    log(f"tl.infercnv on the GTF-annotated AnnData: {report['infercnv_sec']:.3f}s, launches {launches}, X_cnv and "
        f"chr_pos bit-identical to phase 4's")
    del adata

    if has_mpl:
        with tempfile.TemporaryDirectory() as td:
            walls = _plots(big, synthetic, Path(td))
        report.update({f"{k}_sec": v for k, v in walls.items()})
    else:
        report.update(heatmap_sec=None, summary_sec=None, umap_sec=None, plots="not run: no matplotlib")
    report["cells"] = N_CELLS
    print(json.dumps({"annotate_and_plot": report}), flush=True)


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
    return {"launches": launches, "wall": wall, "expr": expr, "obs": obs, "var": var, "kw": kw,
            "x_cnv": adata.obsm["X_cnv"], "genes": genes}


def _dense_digest(x: np.ndarray) -> str:
    """sha256 of a dense float32 result with every zero as +0 (what a CSR of it stores)."""
    import hashlib

    x = np.ascontiguousarray(x, dtype=np.float32)
    return hashlib.sha256(np.where(x == 0, np.float32(0), x).tobytes()).hexdigest()


def rank_child(backend: str, rank: int, world: int, init_file: str, data_dir: str, lo: int, hi: int,
               out_file: str) -> int:
    """One rank of phase 12 (b) / (c), run as ``python3 chip_smoke.py --rank-child ...``.

    Reads phase 4's CSR and reference from ``data_dir``, packs its rows
    ``lo:hi``, runs ``parallel.distributed.infercnv_distributed`` on the card
    and writes its rows' digest, wall and kernel launches to ``out_file``.
    """
    import scipy.sparse as sp
    import torch
    import torch.distributed as dist

    from infercnvpy_tpu_torch.genome import build_window_plan
    from infercnvpy_tpu_torch.ops.infercnv_kernel import _pack_lut, pack_columns, pack_csr
    from infercnvpy_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    if backend == "nccl":
        # one rank: initialize() would do nothing, so the group is made here to run NCCL's all_gather
        dist.init_process_group("nccl", init_method=f"file://{init_file}", world_size=world, rank=rank)
    else:
        distributed.initialize(backend=backend, init_method=f"file://{init_file}", world_size=world, rank=rank)
    var = make_var(N_GENES)
    plan = build_window_plan(var, 100, 10)
    lut = _pack_lut(plan, N_GENES)
    d = Path(data_dir)
    indptr = np.load(d / "indptr.npy", mmap_mode="r")
    a, b = int(indptr[lo]), int(indptr[hi])
    data, indices = (np.array(np.load(d / f"{name}.npy", mmap_mode="r")[a:b]) for name in ("data", "indices"))
    local = sp.csr_matrix((data, indices, np.array(indptr[lo : hi + 1]) - a), shape=(hi - lo, N_GENES))
    packed = pack_csr(local, plan, lut, dtype=np.float32)
    ref = pack_columns(np.load(d / "reference.npy").astype(np.float32), plan, lut)
    chunk_ids = np.arange(lo, hi) // E2E_KW["chunksize"]
    _reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    x_res, _ = distributed.infercnv_distributed(
        packed, ref, chunk_ids, plan, lfc_clip=E2E_KW["lfc_clip"], dynamic_threshold=E2E_KW["dynamic_threshold"],
        num_chunks=-(-N_CELLS // E2E_KW["chunksize"]),
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    report = {
        "backend": dist.get_backend(), "rank": rank, "world_size": dist.get_world_size(), "rows": [lo, hi],
        "device": str(x_res.device), "digest": _dense_digest(x_res.cpu().numpy()), "infercnv_distributed_sec": wall,
        "launches": _read_counts(), "total_sec": time.perf_counter() - t0,
    }
    dist.destroy_process_group()
    Path(out_file).write_text(json.dumps(report))
    return 0


def _spawn_ranks(specs: list, data_dir: Path) -> list:
    """Run each ``(backend, rank, world, init_file, lo, hi)`` as a child of this script, all at once; their reports."""
    import os

    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo"}
    procs = []
    for i, (backend, rank, world, init_file, lo, hi) in enumerate(specs):
        out = data_dir / f"rank_report_{i}.json"
        cmd = [sys.executable, str(Path(__file__).resolve()), "--rank-child", backend, str(rank), str(world),
               str(init_file), str(data_dir), str(lo), str(hi), str(out)]
        procs.append((subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out))
    reports, failed = [], []
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for (p, out), spec in zip(procs, specs):
            try:
                text = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
            except subprocess.TimeoutExpired:
                failed.append(f"{spec[0]} rank {spec[1]} timed out after {RANK_TIMEOUT}s")
                continue
            if p.returncode != 0 or not out.exists():
                failed.append(f"{spec[0]} rank {spec[1]} failed (rc={p.returncode}):\n{text[-4000:]}")
                continue
            reports.append(json.loads(out.read_text()))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError("\n".join(failed))
    return reports


def phase_multi_device(e2e: dict, gene: dict, synthetic) -> dict:
    """Phase 12: two cell shards on the one card, two gloo ranks, one NCCL rank, and the downstream device lists."""
    import scipy.sparse as sp
    import torch

    import infercnvpy_tpu_torch as tcnv
    from infercnvpy_tpu_torch.ops.knn import exact_knn
    from infercnvpy_tpu_torch.tl._infercnv import _LAST_RUN_INFO

    walls: dict = {"infercnv_1device_phase4": e2e["wall"], "gene_1device_phase8": gene["wall"]}
    launches_by_path: dict = {}
    big = e2e["adata"]
    n_batches = -(-N_CELLS // BATCH)

    # (a) tl.infercnv on two shards of the card, against phase 4 and phase 8
    def fresh(expr, obs, var):
        return tcnv.AnnData(X=expr, obs=obs[["cell_type"]].copy(), var=var[["chromosome", "start", "end"]].copy())

    a = fresh(e2e["expr"], big.obs, big.var)
    kw = dict(reference_key="cell_type", reference_cat=e2e["cats"])
    _reset_counts()
    walls["infercnv_2shards_first"] = _timed(lambda: tcnv.tl.infercnv(a, device=TWO_SHARDS, **kw))
    launches = _read_counts()
    launches_by_path["infercnv_102400_2shards"] = launches
    info = dict(_LAST_RUN_INFO)
    if info != {"n_devices": 2, "sharded": True, "device_densify": False}:
        raise AssertionError(f"_LAST_RUN_INFO of the two-shard run: {info}")
    if launches["fused_window"] != 2 * n_batches:
        raise AssertionError(f"fused_window ran {launches['fused_window']} times for {n_batches} batches of 2 shards")
    if not _csr_equal(a.obsm["X_cnv"], big.obsm["X_cnv"]) or a.uns["cnv"]["chr_pos"] != big.uns["cnv"]["chr_pos"]:
        raise AssertionError("X_cnv or chr_pos of the two-shard run differs from phase 4's")
    # in turns after the checked run (whose first pinned host buffers are allocated cold): the card alone
    # with the host packer the shards use, then the shards again
    one = fresh(e2e["expr"], big.obs, big.var)
    walls["infercnv_1device_host_pack"] = _timed(
        lambda: tcnv.tl.infercnv(one, device="cuda:0", device_densify=False, **kw))
    if not _csr_equal(one.obsm["X_cnv"], big.obsm["X_cnv"]):
        raise AssertionError("X_cnv of the one-device host-packer run differs from phase 4's")
    walls["infercnv_2shards"] = _timed(lambda: tcnv.tl.infercnv(a, device=TWO_SHARDS, **kw))
    if not _csr_equal(a.obsm["X_cnv"], big.obsm["X_cnv"]):
        raise AssertionError("X_cnv of the second two-shard run differs from phase 4's")
    log(f"multi-device (a): tl.infercnv(device={TWO_SHARDS}) {walls['infercnv_2shards_first']:.3f}s first, "
        f"{walls['infercnv_2shards']:.3f}s again (one device: {e2e['wall']:.3f}s in phase 4, "
        f"{walls['infercnv_1device_host_pack']:.3f}s with the shards' host packer), {info}, launches {launches}; "
        "X_cnv and chr_pos bit-identical to phase 4's")
    del a, one

    g = tcnv.AnnData(X=gene["expr"], obs=gene["obs"].copy(), var=gene["var"].copy())
    _reset_counts()
    walls["gene_2shards"] = _timed(lambda: tcnv.tl.infercnv(g, calculate_gene_values=True, device=TWO_SHARDS,
                                                            **gene["kw"]))
    launches = _read_counts()
    launches_by_path["gene_values_30000_2shards"] = launches
    n_gene_batches = -(-GENE_CELLS // BATCH)
    if launches["fused_window"] != 2 * n_gene_batches or launches["gene_project"] != 2 * n_gene_batches:
        raise AssertionError(f"{launches} for {n_gene_batches} batches of 2 shards")
    if not np.array_equal(g.layers["gene_values_cnv"].view(np.uint32), gene["genes"].view(np.uint32)):
        raise AssertionError("the gene layer of the two-shard run differs from phase 8's")
    if not _csr_equal(g.obsm["X_cnv"], gene["x_cnv"]):
        raise AssertionError("X_cnv of the two-shard gene run differs from phase 8's")
    log(f"multi-device (a): tl.infercnv(calculate_gene_values=True, device={TWO_SHARDS}) {walls['gene_2shards']:.3f}s "
        f"(phase 8, one device: {gene['wall']:.3f}s), launches {launches}; gene layer and X_cnv bit-identical to "
        f"phase 8's")
    del g

    # (b) two gloo ranks on the card, each with half of phase 4's cells; (c) one NCCL rank; all at once
    x4 = big.obsm["X_cnv"]
    half = N_CELLS // 2
    with tempfile.TemporaryDirectory() as td:
        d = Path(td)
        for name in ("indptr", "indices", "data"):
            np.save(d / f"{name}.npy", getattr(e2e["expr"], name))
        np.save(d / "reference.npy", e2e["reference"])
        t = time.perf_counter()
        reports = _spawn_ranks(
            [("gloo", 0, 2, d / "gloo_init", 0, half), ("gloo", 1, 2, d / "gloo_init", half, N_CELLS),
             ("nccl", 0, 1, d / "nccl_init", 0, NCCL_CELLS)], d)
        walls["ranks_spawned_to_done"] = time.perf_counter() - t
    for r in reports:
        lo, hi = r["rows"]
        if r["digest"] != _dense_digest(x4[lo:hi].toarray()):
            raise AssertionError(f"{r['backend']} rank {r['rank']}: rows {lo}:{hi} differ from phase 4's")
        if r["launches"]["fused_window"] != 1:
            raise AssertionError(f"{r['backend']} rank {r['rank']} launched {r['launches']}")
        key = f"{r['backend']}_rank{r['rank']}_of_{r['world_size']}"
        walls[f"{key}_infercnv_distributed"] = r["infercnv_distributed_sec"]
        walls[f"{key}_process"] = r["total_sec"]
        launches_by_path[f"infercnv_distributed_{key}"] = r["launches"]
    log("multi-device (b, c): " + "; ".join(
        f"{r['backend']} rank {r['rank']} of {r['world_size']} on {r['device']}, rows {r['rows'][0]}:{r['rows'][1]}, "
        f"infercnv_distributed {r['infercnv_distributed_sec']:.3f}s, launches {r['launches']['fused_window']}"
        for r in reports) + "; every rank's rows bit-identical to phase 4's")

    # (d) the downstream entry points on phase 9a's 20,000 synthetic cells: two shards against the card alone
    def fresh_syn():
        s = tcnv.AnnData(X=synthetic.X, obs=synthetic.obs[["cell_type", "cnv_leiden"]].copy(), var=synthetic.var)
        s.obsm["X_cnv"] = synthetic.obsm["X_cnv"]
        return s

    s1, s2 = fresh_syn(), fresh_syn()
    walls["pca_1device"] = _timed(lambda: tcnv.tl.pca(s1, device="cuda:0"))
    walls["pca_2shards"] = _timed(lambda: tcnv.tl.pca(s2, device=TWO_SHARDS))
    n = synthetic.n_obs
    sv1, sv2 = (np.sqrt(s.uns["cnv_pca"]["variance"] * (n - 1)) for s in (s1, s2))
    np.testing.assert_allclose(sv2, sv1, rtol=1e-6)
    s2.obsm["X_cnv_pca"] = s1.obsm["X_cnv_pca"]  # the kNN stages compared on the same scores
    walls["neighbors_1device"] = _timed(lambda: tcnv.pp.neighbors(s1, device="cuda:0"))
    walls["neighbors_2shards"] = _timed(lambda: tcnv.pp.neighbors(s2, device=TWO_SHARDS))
    knn1 = exact_knn(s1.obsm["X_cnv_pca"], 15, device="cuda:0")
    knn2 = exact_knn(s1.obsm["X_cnv_pca"], 15, device=TWO_SHARDS)
    if not (np.array_equal(knn1[1], knn2[1]) and _bits_equal(knn1[0], knn2[0])):
        raise AssertionError("kNN on two shards differs from the card alone")
    d1, d2 = (sp.csr_matrix(s.obsp["cnv_neighbors_distances"]) for s in (s1, s2))
    if not _csr_equal(d1, d2):
        raise AssertionError("pp.neighbors' distances on two shards differ from the card alone")
    scores = {}
    for name, dev in (("1device", "cuda:0"), ("2shards", TWO_SHARDS)):
        walls[f"cnv_score_{name}"], scores[f"cnv_{name}"] = _timed_result(
            lambda: tcnv.tl.cnv_score(s1, groupby="cnv_leiden", inplace=False, device=dev))
        walls[f"ithcna_{name}"], scores[f"ith_{name}"] = _timed_result(
            lambda: tcnv.tl.ithcna(s1, "cnv_leiden", inplace=False, device=dev))
    host = tcnv.tl.cnv_score(s1, groupby="cnv_leiden", inplace=False)
    rel = {}
    for what in ("cnv", "ith"):
        a1, a2 = scores[f"{what}_1device"], scores[f"{what}_2shards"]
        if set(a1) != set(a2):
            raise AssertionError(f"{what} scores on two shards cover other groups than on the card alone")
        rel[what] = max(abs(a2[k] - a1[k]) / abs(a1[k]) for k in a1)
        if rel[what] > 1e-9:
            raise AssertionError(f"{what} scores on two shards differ from the card alone by {rel[what]:.3e} relative")
    rel_host = max(abs(scores["cnv_2shards"][k] - host[k]) / abs(host[k]) for k in host)
    log(f"multi-device (d) at {n:,} synthetic cells: PCA sigma within {np.max(np.abs(sv2 / sv1 - 1)):.3e} relative, "
        f"kNN indices and distances and pp.neighbors' graph equal to the card alone; cnv_score / ithcna within "
        f"{rel['cnv']:.3e} / {rel['ith']:.3e} relative (cnv_score against the host's float32 sums: {rel_host:.3e})")
    print(json.dumps({"multi_device": {"card_shards": TWO_SHARDS, "walls_sec": walls,
                                       "note": "two shards share one card: the walls show sharding's overhead, "
                                               "not a multi-GPU speed-up"}}), flush=True)
    return {"launches_by_path": launches_by_path, "walls": walls}


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
    downstream = phase_downstream_quality()
    synthetic = downstream.pop("adata")
    scale = phase_downstream_scale(e2e["adata"])
    phase_annotate_and_plot(e2e, synthetic, scale.pop("adata"))
    e2e_launches = e2e["launches"]
    del scale
    gene_kernel = phase_gene_kernels(probe["write_gb_per_s"])
    selects = phase_select_kernels()
    gene_e2e = phase_gene_e2e()
    multi = phase_multi_device(e2e, gene_e2e, synthetic)
    del e2e, synthetic
    # each path's kernels take their launches from that path's run
    kernels[0]["launches"] = e2e_launches["fused_window"]
    kernels[0]["launches_by_path"] = {
        "infercnv_102400": e2e_launches["fused_window"], "gene_values_30000": gene_e2e["launches"]["fused_window"],
        "downstream_20000": downstream["launches"]["fused_window"],
        **{path: n["fused_window"] for path, n in multi["launches_by_path"].items()},
    }
    gene_kernel["launches"] = gene_e2e["launches"]["gene_project"]
    gene_kernel["launches_by_path"] = {
        "gene_values_30000": gene_e2e["launches"]["gene_project"],
        "gene_values_30000_2shards": multi["launches_by_path"]["gene_values_30000_2shards"]["gene_project"],
    }
    on_path = [kernels[0], gene_kernel]
    off_path = [kernels[1], *selects]
    for k in off_path:
        k["launches"] = (e2e_launches[k["name"]] + gene_e2e["launches"][k["name"]] + downstream["launches"][k["name"]]
                         + sum(n[k["name"]] for n in multi["launches_by_path"].values()))
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
    if sys.argv[1:2] == ["--rank-child"]:
        backend, rank, world, init_file, data_dir, lo, hi, out_file = sys.argv[2:10]
        sys.exit(rank_child(backend, int(rank), int(world), init_file, data_dir, int(lo), int(hi), out_file))
    sys.exit(main())
