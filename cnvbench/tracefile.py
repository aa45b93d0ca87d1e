"""Reduction of a ``torch.profiler`` Chrome trace (``profiling.trace``) to the numbers the readers use.

A frozen extension of ``chip_smoke.py::_trace_summary``: device busy time is
the union of kernel, copy and memset spans, here per device and clipped to
the traced window, which runs from the first ``cnvbench.call`` region's start
to the last one's end.  Times in the trace are microseconds.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_REGION = "cnvbench.call"
#: CUDA runtime calls that start device work or allocate for it; a call's prelude ends at the first.  Event
#: records are left out: the caching allocators record events when they free the previous call's blocks
WORK_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cudaHostAlloc", "cudaMalloc")


def union(spans: list) -> list:
    """Sorted, disjoint cover of the ``(start, end)`` spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(intervals: list, lo: float, hi: float) -> float:
    """Length of ``[lo, hi]`` that the disjoint ``intervals`` cover."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in intervals)


@dataclass
class Trace:
    window: tuple  # (start, end) of the traced calls, trace microseconds
    calls: list  # (start, end) of each call region
    busy: dict  # device -> disjoint busy intervals inside the window
    device_ops: dict  # device operation name -> seconds, all devices
    kernels: list  # (name, start, dur) of every kernel inside the window
    runtime: list = field(default_factory=list)  # (name, start) of the CUDA runtime calls that start work
    n_devices: int = 0  # the devices the run uses; one that the trace never shows busy counts as idle throughout

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self, device) -> float:
        return covered(self.busy[device], *self.window) / 1e6

    def idle_share(self) -> float:
        """1 - busy / window, the mean over the run's devices."""
        return 1.0 - self.mean_busy_s() / self.window_s

    def mean_busy_s(self) -> float:
        """Busy seconds inside the window, the mean over the run's devices."""
        return sum(self.busy_s(d) for d in self.busy) / max(self.n_devices, len(self.busy))

    def all_busy(self) -> list:
        """Disjoint intervals in which some device was busy."""
        return union([tuple(iv) for ivs in self.busy.values() for iv in ivs])


def read(path: Path, n_devices: int = 0) -> Trace:
    """The trace at ``path``, reduced; ``n_devices`` is how many devices the run uses."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    calls = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == CALL_REGION)
    if not calls:
        raise ValueError(f"the trace {path} holds no {CALL_REGION!r} region")
    lo, hi = calls[0][0], calls[-1][1]
    spans: dict = {}
    ops: dict = {}
    kernels, runtime = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        a = float(e["ts"])
        dur = float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            if a + dur < lo or a > hi:
                continue
            dev = (e.get("args") or {}).get("device", e.get("pid"))
            spans.setdefault(dev, []).append((a, a + dur))
            name = e.get("name", "")[:80]
            ops[name] = ops.get(name, 0.0) + covered([(a, a + dur)], lo, hi) / 1e6
            if cat == "kernel":
                kernels.append((e.get("name", ""), a, dur))
        elif cat in ("cuda_runtime", "cuda_driver") and lo <= a <= hi and e.get("name", "").startswith(WORK_CALLS):
            runtime.append((e.get("name", ""), a))
    if not spans:
        raise ValueError(f"the trace {path} holds no device activity inside the traced calls")
    busy = {d: union(s) for d, s in spans.items()}
    return Trace(window=(lo, hi), calls=calls, busy=busy, device_ops=ops, kernels=kernels,
                 runtime=sorted(runtime, key=lambda r: r[1]), n_devices=n_devices)


def first_work(trace: Trace) -> list:
    """``(name, seconds)`` of each call's first CUDA runtime call that starts work, from the call's start."""
    out = []
    for a, b in trace.calls:
        first = next(((n, t) for n, t in trace.runtime if a <= t <= b), None)
        if first is not None:
            out.append((first[0], (first[1] - a) / 1e6))
    return out


def preludes(trace: Trace) -> list:
    """Seconds from each call's start to its first CUDA runtime call that starts work (calls with one)."""
    return [sec for _, sec in first_work(trace)]


def idle_by_host(trace: Trace, samples: list, offset_us: float) -> dict:
    """Idle device seconds by what the host was doing: each host sample taken while no device was busy counts
    the time to the next sample for its label.  ``samples`` are ``(perf_counter seconds, label)``, in order;
    ``offset_us`` maps them to trace time (trace = perf * 1e6 + offset)."""
    busy = trace.all_busy()
    out: dict = {}
    starts = [a for a, _ in busy]
    for (t, label), (t_next, _) in zip(samples, samples[1:]):
        ts = t * 1e6 + offset_us
        if not trace.window[0] <= ts <= trace.window[1]:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and busy[i][0] <= ts <= busy[i][1]:
            continue
        out[label] = out.get(label, 0.0) + (t_next - t)
    return out
