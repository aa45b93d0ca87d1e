"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> plain C ABI -> ctypes).

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library with
a plain C interface, at first use, into ``infercnvpy_tpu_torch/_build/``:
one ``nvcc -c`` per source, all started together, then one link.  The
file name carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one loads the existing library.  The build writes a
temporary file and renames it, so concurrent processes never load a partial
library.  A failed build raises with nvcc's stderr; nothing falls back.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["library", "build", "bind", "compile_sources", "check", "current_stream", "nvcc_path", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("select.cuh", "warp_select.cuh", "fused_window.cu", "row_median.cu", "row_select.cu", "gene_project.cu", "write_probe.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, ref2, tasks, tile_ptr, wtab, out, stats, rows, width, n_windows, n_tasks, n_small, packed_len, Q,
    # step, window, single_ref, n_tiles, tile_conv, plane_stride, row_stage, tail_off, smem_bytes, max_smem,
    # threads, lfc_clip, inv_sum, stream
    "fused_window_launch": (_P, _P, _P, _P, _P, _P, _P, *([_I] * 18), _F, _F, _P),
    # x, out, rows, width, threads, stream
    "row_median_launch": (_P, _P, _I, _I, _I, _P),
    # x, out, rows, width, stream
    "row_median_warp_launch": (_P, _P, _I, _I, _P),
    "fused_window_smem_budget": (_I,),
    # x, wts, out, rows, width, total, threads, stream
    "row_median_weighted_launch": (_P, _P, _P, _I, _I, _I, _I, _P),
    # x, wts, out, rows, width, total, stream
    "row_median_weighted_warp_launch": (_P, _P, _P, _I, _I, _I, _P),
    # x, out, rows, width, k, threads, stream
    "row_kth_smallest_launch": (_P, _P, _I, _I, _I, _I, _P),
    # x, out, rows, width, k, stream
    "row_kth_smallest_warp_launch": (_P, _P, _I, _I, _I, _P),
    # x, thr, g_lo, g_hi, g_counts, gidx, packed4, out, rows, n_windows, n_groups, n_covered, packed_stride,
    # gate, max_smem, threads, stream
    "gene_project_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "gene_project_max_smem": (),
    # x, out, n, ld, w, mode, stream
    "write_probe_launch": (_P, _P, _I, _I, _I, _I, _P),
}

_LIB = None


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, then ``PATH``, then the default toolkit."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH")


def _digest() -> str:
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently; return their stderr, raising on the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, proc, err in zip(cmds, procs, errs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    return errs


def compile_sources(cus: list[Path], out: Path, verbose: bool = False) -> None:
    """Compile the ``.cu`` files into the shared library ``out``: one ``nvcc -c`` each, all at once, then a link.

    Works in a temporary directory beside ``out`` and renames the finished
    library into place.  ``verbose`` prints what ``ptxas -v`` says.
    """
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(Path(tmp) / f"{c.stem}.o") for c in cus]
        ptxas = ["-Xptxas", "-v"] if verbose else []
        errs = _run_all([[nvcc, *NVCC_FLAGS, *ptxas, "-c", str(c), "-o", o] for c, o in zip(cus, objs)])
        lib = str(Path(tmp) / "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        if verbose:
            print("".join(errs))
        os.replace(lib, out)


def build(verbose: bool = False) -> Path:
    """Compile the kernels if no library for the current sources exists; return its path."""
    out = BUILD_DIR / f"libinfercnv_kernels-{_digest()}.so"
    if not out.exists():
        compile_sources([CSRC / s for s in SOURCES if s.endswith(".cu")], out, verbose)
    return out


def bind(lib: ctypes.CDLL, signatures: dict | None = None) -> ctypes.CDLL:
    """Give the C entry points of ``lib`` their argument types (``signatures``: this tree's by default)."""
    for name, args in (_SIGNATURES if signatures is None else signatures).items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build())))
    return _LIB


def current_stream(device) -> int:
    """Raw handle of PyTorch's current CUDA stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")
