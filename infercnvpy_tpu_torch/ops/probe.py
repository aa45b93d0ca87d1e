"""Device-memory write-bandwidth probe (counterpart of ``tools/probe_write_bw.py``).

The probe writes an ``(n, w)`` float32 matrix from an ``(n, 256)`` input so
that its time is the card's time to write ``n * w * 4`` bytes, the ceiling
against which the output-bound kernels (the fused window kernel, the gene
projection) are read.  Two modes, as the TPU tool's kernel
(``tools/probe_write_bw.py:14-19``):

* ``"bcast"``:  ``out[r, c] = x[r, 0] * 1.000001``
* ``"blocks"``: ``out[r, 128 q + j] = x[r, j] * (q + 1)`` for ``q < w / 128``

:func:`write_probe_cuda` launches ``csrc/write_probe.cu`` (f32, CUDA; a CPU
tensor raises), :func:`write_probe_plain` is the PyTorch version, and
:func:`write_probe` takes the kernel for a CUDA tensor and the plain version
for a CPU one.  Both compute one float32 multiply per value, so they agree
bit for bit.  The TPU tool also swept its VMEM row tile (``rt``); a CUDA
block has no counterpart of that tile, so there is no sweep here.

    python -m infercnvpy_tpu_torch.ops.probe

prints one line per mode with the kernel's time and write rate at the TPU
tool's shape, 16,384 × 19,968 (1.309 GB).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["write_probe", "write_probe_plain", "write_probe_cuda", "write_bandwidth", "MODES", "N", "W", "X_COLS"]

MODES = ("bcast", "blocks")
N, W = 16384, 19968  # the TPU tool's shape (tools/probe_write_bw.py:11)
X_COLS = 256  # its input tile width (:24)
_BCAST_SCALE = np.float32(1.000001)


def _check(x: torch.Tensor, w: int, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be a 2-D float32 tensor, got {x.dtype} of shape {tuple(x.shape)}")
    if w <= 0 or w % 4:
        raise ValueError(f"w must be a positive multiple of 4, got {w}")
    if mode == "blocks" and (w % 128 or x.shape[1] < 128):
        raise ValueError(f'"blocks" needs w % 128 == 0 and x with >= 128 columns, got w={w}, x {tuple(x.shape)}')


def write_probe_plain(x: torch.Tensor, w: int, mode: str = "blocks") -> torch.Tensor:
    """The probe's output in PyTorch (any device)."""
    _check(x, w, mode)
    n = x.shape[0]
    if mode == "bcast":
        scale = torch.tensor(_BCAST_SCALE, device=x.device)
        return (x[:, :1] * scale).expand(n, w).contiguous()
    q = torch.arange(1, w // 128 + 1, dtype=torch.float32, device=x.device)
    return (x[:, None, :128] * q[None, :, None]).reshape(n, w)


def write_probe_cuda(x: torch.Tensor, w: int, mode: str = "blocks") -> torch.Tensor:
    """Launch ``csrc/write_probe.cu`` on a float32 CUDA tensor; raises on any failure."""
    _check(x, w, mode)
    if not x.is_cuda:
        raise ValueError(f"write_probe_cuda takes a CUDA tensor, got one on {x.device}")
    x = x.contiguous()
    if x.shape[1] % 4:
        raise ValueError(f"x rows must be 16-byte aligned (columns % 4 == 0), got {x.shape[1]} columns")
    n = x.shape[0]
    out = torch.empty((n, w), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.write_probe_launch(x.data_ptr(), out.data_ptr(), n, x.shape[1], w, MODES.index(mode),
                                     _build.current_stream(x.device))
    _build.check(err, "write_probe")
    write_probe_cuda.launches += 1
    return out


write_probe_cuda.launches = 0


def write_probe(x: torch.Tensor, w: int, mode: str = "blocks") -> torch.Tensor:
    """The probe: the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return write_probe_cuda(x, w, mode)
    return write_probe_plain(x, w, mode)


def write_bandwidth(n: int = N, w: int = W, mode: str = "blocks", reps: int = 5, seed: int = 0) -> float:
    """The kernel's write rate in GB/s (1e9 bytes) on the current CUDA device.

    CUDA-event time of one launch, median of ``reps`` after one warm-up.
    The output (1.3 GB at the default shape) is far larger than the 50 MB L2
    cache, so every launch writes through to device memory.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("write_bandwidth needs a CUDA device (torch.cuda.is_available() is False)")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, X_COLS), generator=gen, device="cuda", dtype=torch.float32)
    out = write_probe_cuda(x, w, mode)
    del out
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = write_probe_cuda(x, w, mode)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del out
    return n * w * 4 / 1e9 / (float(np.median(times)) / 1e3)


def main() -> None:
    gb = N * W * 4 / 1e9
    for mode in MODES:
        rate = write_bandwidth(N, W, mode)
        print(f"{mode:6s}: {gb / rate * 1e3:7.3f} ms  ({rate:7.1f} GB/s write)", flush=True)


if __name__ == "__main__":
    main()
