"""Trace capture, stage spans and annotation on ``torch.profiler`` (counterpart of ``infercnvpy_tpu/profiling.py``).

* :func:`trace` — context manager that profiles the enclosed block (host
  activity, and the device's kernels and copies where CUDA is present) and
  writes a Chrome trace (``trace.json``, readable by Perfetto or
  ``chrome://tracing``) into a directory;
* :func:`span` and :func:`count` — the program's own stage spans and
  counters, recorded on every thread while :func:`trace` runs and written
  into the same ``trace.json`` (category ``program_span``, a track of their
  own for each thread) on the trace's clock; :data:`last_spans` keeps them;
* :func:`annotate` — a named region on the trace's host timeline
  (``torch.profiler.record_function``);
* ``INFERCNVPY_TPU_TRACE_DIR`` — when set, :func:`maybe_trace` (which
  ``tl.infercnv`` runs inside) traces every call into a fresh subdirectory.

``tl.infercnv`` opens these spans (``tl/_infercnv.py``): the root
``infercnv`` (attrs ``cells``, ``genes``, ``devices``), then
``infercnv.reference``, ``infercnv.subset``, ``infercnv.plan``,
``infercnv.setup`` (child ``infercnv.slots``), per batch ``infercnv.pack``
and ``infercnv.h2d`` (on the packer thread where the batches are
pipelined), ``infercnv.launch``, ``infercnv.d2h``, ``infercnv.csr``,
``infercnv.gene_unpack``, ``infercnv.checkpoint``, ``infercnv.resume``,
then ``infercnv.stack``, ``infercnv.gene_scatter`` and
``infercnv.gene_reindex``; ``infercnv.wait`` wherever a thread blocks, its
attr ``on`` saying for what (``"pack"``, ``"copies"``, ``"compute"``).  Its
counters: ``pinned_bytes`` (pinned host memory allocated), ``h2d_bytes``,
``d2h_bytes`` and ``gene_d2h_bytes``.

With recording off (no :func:`trace` running), :func:`span` returns one
shared no-op context after a single flag check, and :func:`count` returns.
The stage clock of ``tl/_infercnv.py::_infercnv_compute`` (its ``stats``)
times the same spans, serialized.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import NamedTuple

__all__ = [
    "trace", "span", "count", "current", "annotate", "maybe_trace", "last_trace_dir", "last_spans", "Span",
    "TRACE_FILE", "SPAN_CATEGORY",
]

#: File name of the Chrome trace inside a trace directory.
TRACE_FILE = "trace.json"
#: Category of the program's spans in the Chrome trace.
SPAN_CATEGORY = "program_span"
#: The spans of a thread go on the trace's track ``SPAN_TID_BASE + <its native thread id>``
SPAN_TID_BASE = 1 << 30

#: Directory of the most recent capture (None until the first one completes).
last_trace_dir: str | None = None


class Span(NamedTuple):
    """One recorded span of :data:`last_spans`; ``start`` and ``end`` in the trace's microseconds."""

    name: str
    thread: int  # native id of the thread that ran it
    start: float
    end: float
    id: int
    parent: int | None  # the enclosing span's id, None for a root
    call: int  # id of the root span it belongs to
    attrs: dict
    counts: dict


#: Spans of the most recent capture, in the order they opened (empty until the first one completes).
last_spans: list[Span] = []

_recording = False
_records: list = []
_thread_names: dict = {}  # native thread id -> name, for the trace's span tracks
_ids = itertools.count(1)
_local = threading.local()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Open:
    """A span being recorded: pushed on its thread's stack while open."""

    __slots__ = ("name", "thread", "start", "end", "id", "parent", "call", "attrs", "counts", "_explicit")

    def __init__(self, name: str, parent, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.counts: dict = {}
        self.end = None
        self._explicit = parent

    def __enter__(self):
        stack = _stack()
        parent = self._explicit if self._explicit is not None else (stack[-1] if stack else None)
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.call = self.id if parent is None else parent.call
        self.thread = threading.get_native_id()
        if self.thread not in _thread_names:
            _thread_names[self.thread] = threading.current_thread().name
        stack.append(self)
        _records.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        _stack().pop()
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, parent=None, **attrs):
    """A span ``name`` of the calling thread (context manager), recorded while :func:`trace` runs.

    Its parent is the innermost span open on this thread, or ``parent``
    (what :func:`current` returned on the thread that handed over the work):
    threads do not inherit a stack.  ``attrs`` go into the trace's ``args``.
    """
    if not _recording:
        return _NO_SPAN
    return _Open(name, parent, attrs)


def current():
    """The innermost span open on the calling thread (None when there is none or recording is off)."""
    if not _recording:
        return None
    stack = _stack()
    return stack[-1] if stack else None


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the innermost span open on the calling thread."""
    if not _recording:
        return
    stack = _stack()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def _write_spans(path: Path, records: list) -> list[Span]:
    """Append the closed ``records`` to the Chrome trace at ``path``; returns them on its clock.

    The trace's ``ts`` plus ``baseTimeNanoseconds`` is the Unix time the
    profiler read (absolute microseconds in a trace without that key), the
    clock ``time.time_ns()`` reads.
    """
    doc = json.loads(path.read_text())
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    spans, events, tracks = [], [], {}
    for r in records:
        if r.end is None:
            continue
        s = Span(r.name, r.thread, (r.start - base) / 1e3, (r.end - base) / 1e3, r.id, r.parent, r.call,
                 r.attrs, r.counts)
        spans.append(s)
        tid = SPAN_TID_BASE + s.thread
        tracks.setdefault(tid, f"spans: {_thread_names.get(s.thread, 'thread')} ({s.thread})")
        events.append({"ph": "X", "cat": SPAN_CATEGORY, "name": s.name, "pid": pid, "tid": tid, "ts": s.start,
                       "dur": s.end - s.start, "args": {"id": s.id, "parent": s.parent, "call": s.call, **s.attrs,
                                                        "counts": s.counts}})
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": label}}
               for tid, label in tracks.items()]
    if events:
        doc["traceEvents"].extend(events)
        path.write_text(json.dumps(doc))
    return spans


@contextlib.contextmanager
def trace(logdir: str | os.PathLike):
    """Profile the enclosed block and write ``<logdir>/trace.json``; yields ``str(logdir)``.

    The program's spans opened inside the block, on any thread, are
    recorded and written into the same trace, and kept in :data:`last_spans`.

    >>> with profiling.trace("/tmp/cnv_trace"):
    ...     tl.infercnv(adata)
    """
    global last_trace_dir, last_spans, _recording, _records
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    records = _records = []
    with profile(activities=activities) as prof:
        _recording = True
        try:
            yield str(path)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            _recording = False
    prof.export_chrome_trace(str(path / TRACE_FILE))
    last_spans = _write_spans(path / TRACE_FILE, records)
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
