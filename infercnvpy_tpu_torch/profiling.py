"""Trace capture and annotation on ``torch.profiler`` (counterpart of ``infercnvpy_tpu/profiling.py``).

* :func:`trace` — context manager that profiles the enclosed block (host
  activity, and the device's kernels and copies where CUDA is present) and
  writes a Chrome trace (``trace.json``, readable by Perfetto or
  ``chrome://tracing``) into a directory;
* :func:`annotate` — a named region on the trace's host timeline
  (``torch.profiler.record_function``);
* ``INFERCNVPY_TPU_TRACE_DIR`` — when set, :func:`maybe_trace` (which
  ``tl.infercnv`` runs inside) traces every call into a fresh subdirectory.

The stage clock of ``tl/_infercnv.py::_infercnv_compute`` (its ``stats``)
is the wall-clock side; this module is the trace side: per-kernel device
time, copies, and the device's idle gaps.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

__all__ = ["trace", "annotate", "maybe_trace", "last_trace_dir", "TRACE_FILE"]

#: File name of the Chrome trace inside a trace directory.
TRACE_FILE = "trace.json"

#: Directory of the most recent capture (None until the first one completes).
last_trace_dir: str | None = None


@contextlib.contextmanager
def trace(logdir: str | os.PathLike):
    """Profile the enclosed block and write ``<logdir>/trace.json``; yields ``str(logdir)``.

    >>> with profiling.trace("/tmp/cnv_trace"):
    ...     tl.infercnv(adata)
    """
    global last_trace_dir
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield str(path)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path / TRACE_FILE))
    last_trace_dir = str(path)


def annotate(name: str):
    """Named host-timeline region (context manager), nestable."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def maybe_trace(stage: str):
    """Trace this block iff ``INFERCNVPY_TPU_TRACE_DIR`` is set; yields the directory or None.

    Each capture lands in ``$INFERCNVPY_TPU_TRACE_DIR/<stage>-<timestamp>-<pid>``,
    so repeated calls never overwrite each other.  With the variable unset
    this imports nothing and does nothing.
    """
    root = os.environ.get("INFERCNVPY_TPU_TRACE_DIR", "")
    if not root:
        yield None
        return
    dest = Path(root) / f"{stage}-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
    with trace(dest) as d:
        yield d
