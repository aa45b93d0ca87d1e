"""The card: presence, identity, peak memory, and the H100's published peaks.

``H100_BYTES_PER_S``, ``H100_F32_OPS_PER_S`` and :func:`bound` are frozen
copies of ``chip_smoke.py``'s (NVIDIA's data sheet for the H100 SXM).
"""

from __future__ import annotations

import os
import subprocess

H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12


class NoDevice(RuntimeError):
    """The run needs more CUDA devices than this machine shows."""


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time the card could take: the larger of bytes / memory rate and operations / f32 rate."""
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": int(n_bytes), "operations": int(n_ops), "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def limit_visible(chips: int) -> None:
    """Show the process only the first ``chips`` CUDA devices (call before CUDA initialises)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = [d for d in visible.split(",") if d] if visible else [str(i) for i in range(chips)]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:chips])


def require_cuda(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False: this benchmark runs on NVIDIA GPUs only")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} CUDA devices, this machine shows {torch.cuda.device_count()}")


def power_line() -> str:
    """``name, power.limit`` of each card as ``nvidia-smi`` reads them ("" where it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip())


def reset_peaks(n_dev: int) -> None:
    import torch

    for i in range(n_dev):
        torch.cuda.reset_peak_memory_stats(i)


def peak_bytes(n_dev: int) -> int:
    """``max_memory_allocated`` of the fullest of the first ``n_dev`` devices."""
    import torch

    return max(int(torch.cuda.max_memory_allocated(i)) for i in range(n_dev))


def synchronize(n_dev: int) -> None:
    import torch

    for i in range(n_dev):
        torch.cuda.synchronize(i)
