"""Run one cell of ``BENCHMARK.json`` once and print its result as the last line of standard output.

    python3 -m cnvbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` runs a few calls under ``torch.profiler``, then
the program's serialized stage clock, and reports the cell's per-layer
metrics.  Both check the outputs against the
plain reference once the window has closed.  Without enough CUDA devices, or
with JAX or the JAX package loaded, the run prints no result and exits
non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

from cnvbench import guard, hw, spec  # noqa: E402

EXIT_NO_DEVICE = 2
EXIT_FORBIDDEN = 3
CALL_REGION = "cnvbench.call"
#: the trace run's calls: at least TRACE_MIN_CALLS, and on until TRACE_SECONDS have passed
TRACE_SECONDS = 5.0
TRACE_MIN_CALLS = 2


def log(msg: str) -> None:
    print(f"[cnvbench +{time.perf_counter() - T0:7.2f}s] {msg}", file=sys.stderr, flush=True)


@dataclass
class Run:
    """What a metric reader reads (``metrics/<name>.py::read(run)``)."""

    cell: spec.Cell
    calls: list = field(default_factory=list)  # (start, end, cells) of each call in the window
    setup_s: float | None = None
    peak_bytes: int | None = None
    trace: object = None  # tracefile.Trace of the traced calls
    stats: dict | None = None  # the program's serialized stage clock, where the driver has one
    shapes: dict | None = None  # what the traced calls computed
    host_idle: dict = field(default_factory=dict)  # idle device seconds by host activity


def _set_cache_dirs(root: Path) -> None:
    """Fixed cache directories inside the checkout for whatever builds kernels at run time."""
    cache = root / ".cache" / "cnvbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def window(driver, seconds: float) -> list:
    """Calls back to back from the first call's start until ``seconds`` have passed; whole calls only."""
    calls = []
    first = time.perf_counter()
    k = 0
    while True:
        t0 = time.perf_counter()
        if t0 - first >= seconds:
            return calls
        n = driver.call(k)
        calls.append((t0, time.perf_counter(), n))
        k += 1


def traced(driver, run: Run) -> None:
    """The trace run's calls under the profiler and the host sampler, then the program's stage clock."""
    from infercnvpy_tpu_torch import profiling

    from cnvbench import sampler, tracefile

    k = 0
    marks = []
    with tempfile.TemporaryDirectory(prefix="cnvbench-trace-") as td:
        with sampler.Sampler() as samples, profiling.trace(td):
            first = time.perf_counter()
            while len(marks) < TRACE_MIN_CALLS or time.perf_counter() - first < TRACE_SECONDS:
                marks.append(time.perf_counter())
                with profiling.annotate(CALL_REGION):
                    driver.call(k)
                k += 1
        run.trace = tracefile.read(Path(td) / profiling.TRACE_FILE, run.cell.chips)
    offsets = [a - m * 1e6 for (a, _), m in zip(run.trace.calls, marks)]
    run.host_idle = tracefile.idle_by_host(run.trace, samples.samples, statistics.median(offsets))
    log(f"traced {len(marks)} calls; first work call of each: {tracefile.first_work(run.trace)[:6]}")
    run.shapes = driver.shapes(len(marks))
    run.stats = driver.stage_stats()
    if run.stats is not None:
        log("stage clock: " + json.dumps(run.stats, default=str))


def _host_usage(before) -> str:
    """The process's CPU seconds since ``before`` (``getrusage``) and the CPUs it may run on."""
    now = resource.getrusage(resource.RUSAGE_SELF)
    return (f"user {now.ru_utime - before.ru_utime:.2f}s sys {now.ru_stime - before.ru_stime:.2f}s "
            f"on {len(os.sched_getaffinity(0))} cpus")


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: int, device=None,
             bases=(spec.ROOT,)) -> tuple[int, dict | None]:
    """One run of ``workload``: ``(exit code, result or None)``.

    ``device="cpu"`` skips the look for a GPU and runs the program on the
    CPU (the CPU tests' path); ``bases`` are the folders searched for
    ``traffic/``, ``drivers/`` and ``metrics/`` files (``spec.find``).
    """
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, workload, root, bases)
    on_cpu = device == "cpu"
    if not on_cpu:
        _set_cache_dirs(root)
        hw.limit_visible(cell.chips)
        try:
            hw.require_cuda(cell.chips)
        except hw.NoDevice as e:
            log(f"no result: {e}")
            return EXIT_NO_DEVICE, None
        log(f"card: {hw.power_line()}")
    driver = spec.driver(cell.traffic["driver"], bases).Driver(cell, seed, device=device, log=log)
    driver.setup()
    run = Run(cell=cell, setup_s=time.perf_counter() - T0)
    log(f"set-up {run.setup_s:.3f}s")
    if not on_cpu:
        hw.reset_peaks(cell.chips)
    usage0 = resource.getrusage(resource.RUSAGE_SELF)
    if trace:
        traced(driver, run)
        n_calls = len(run.trace.calls)
    else:
        run.calls = window(driver, seconds)
        n_calls = len(run.calls)
        walls = [b - a for a, b, _ in run.calls]
        q = statistics.quantiles(walls * 2, n=4)
        log(f"window: {n_calls} calls in {run.calls[-1][1] - run.calls[0][0]:.3f}s, call walls q1 / median / q3 "
            f"{q[0]:.4f} / {q[1]:.4f} / {q[2]:.4f}s; host {_host_usage(usage0)}")
        log("call walls: " + " ".join(f"{w:.3f}" for w in walls))
    if not on_cpu:
        run.peak_bytes = hw.peak_bytes(cell.chips)
    driver.release()
    readings, failed = driver.check()
    found = guard.forbidden_modules()
    if found:
        log(f"no result: modules of JAX or of the JAX package are loaded: {found}")
        return EXIT_FORBIDDEN, None
    compared = {k: {"value": v, "limit": driver.limits.get(k)} for k, v in readings.items()}
    correct = failed == 0 and all(v["limit"] is not None and v["value"] <= v["limit"] for v in compared.values())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"], bases).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "cpu" if on_cpu else "gpu", "kind": "cpu" if on_cpu else _device_name(),
           "count": 1 if on_cpu else cell.chips, "memory_peak_bytes": run.peak_bytes or 0}
    result = {"correct": correct, "attempted": n_calls, "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.mean_busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": _top(run.trace.device_ops), "idle_gaps": _top(run.host_idle)}
    result["compared"] = compared
    for k, v in compared.items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    return 0, result


def _device_name() -> str:
    import torch

    return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cnvbench.run", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    code, result = run_cell(Path.cwd(), args.workload, args.seed, args.seconds, args.trace)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
