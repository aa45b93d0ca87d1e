"""``BENCHMARK.json`` and the files it names, found by name.

* ``configs/<config>.json`` — a deployment's data (one file per configuration);
* ``traffic/<traffic>.json`` — a traffic mix: ``driver`` and its arguments;
* ``drivers/<driver>.py`` — a module with ``Driver(cell, seed, device, log)``:
  ``setup()``, ``call(k)`` (the window's ``k``-th call; returns the cells it
  passed), ``shapes(calls)`` and ``stage_stats()`` (the trace run;
  ``stage_stats`` returns ``None`` where the driver has no stage clock),
  ``release()``, ``check()`` (``(readings, calls failed)``) and ``limits``;
* ``metrics/<metric>.py`` — a module with ``read(run) -> float | None``.

A metric's name may hold dots (``device_idle.infercnv``), so modules are
loaded from their paths, not imported by dotted name.  Each lookup searches
a list of folders in turn (``bases``: this folder by default), so files
added in another folder are found beside these.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCHMARK_FILE = "BENCHMARK.json"


@dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, its traffic and its metrics."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / BENCHMARK_FILE).read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find(bases, sub: str, file: str) -> Path:
    """``<base>/<sub>/<file>`` in the first of ``bases`` that has it."""
    for base in bases:
        path = Path(base) / sub / file
        if path.exists():
            return path
    raise FileNotFoundError(f"{sub}/{file} not found in {[str(b) for b in bases]}")


def cell(bench: dict, workload: str, root: Path, bases=(ROOT,)) -> Cell:
    """The cell ``workload`` of ``bench`` (read from ``root``), with its configuration and traffic files read."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in {BENCHMARK_FILE}; have {sorted(by_name)}")
    w = by_name[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((Path(root) / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(find(bases, "traffic", f"{w['traffic']}.json").read_text())
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(f"cnvbench._found.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bases=(ROOT,)):
    """The driver module ``drivers/<name>.py``."""
    return _load(find(bases, "drivers", f"{name}.py"), f"driver.{name}")


def metric_reader(name: str, bases=(ROOT,)):
    """The reader ``metrics/<name>.py`` of metric ``name``."""
    return _load(find(bases, "metrics", f"{name}.py"), f"metric.{name}")
