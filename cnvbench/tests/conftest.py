"""Fixtures of the benchmark's CPU tests: a small configuration and cell that run the harness on the CPU."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from cnvbench import spec

#: a cell small enough for a test: 2 samples of 700-1,300 cells x 1,500 genes (some chromosomes
#: hold fewer genes than the window), chunks of 500 cells
TINY_SIZES = {"n_genes": 1500, "samples": {"count": 2, "cells_min": 700, "cells_max": 1300}, "chunksize": 500}


def write_tiny(root: Path, *, traffic: dict | None = None, metrics: list | None = None,
               config_updates: dict | None = None) -> Path:
    """A checkout-like ``root`` with ``BENCHMARK.json`` naming one cell ``tiny.small`` and its files under ``root/bench``.

    Returns the folder that holds the added ``configs/``, ``traffic/`` and ``metrics/``.
    """
    base = root / "bench"
    for sub in ("configs", "traffic", "metrics"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    config = json.loads((spec.ROOT / "configs" / "atlas_102k.json").read_text())
    config["genome"]["n_genes"] = TINY_SIZES["n_genes"]
    config["samples"] = dict(TINY_SIZES["samples"])
    config["infercnv"]["chunksize"] = TINY_SIZES["chunksize"]
    config.update(config_updates or {})
    (base / "configs" / "tiny.json").write_text(json.dumps(config))
    mix = {"driver": "infercnv_loop", "device": None, "infercnv": {"chunksize": TINY_SIZES["chunksize"]}}
    mix.update(traffic or {})
    (base / "traffic" / "small.json").write_text(json.dumps(mix))
    bench = json.loads((spec.ROOT.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "bench/configs/tiny.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = [{"name": "tiny.small", "config": "tiny", "traffic": "small", "chips": 1, "why": "test"}]
    bench["end_to_end"] = [m for m in bench["end_to_end"] if m["name"] in ("cnv_cells_per_s", "sample_s_p90",
                                                                           "setup_s")]
    for m in bench["end_to_end"]:
        m.pop("workloads", None)
    bench["end_to_end"] += metrics or []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


@pytest.fixture
def tiny(tmp_path):
    return tmp_path, write_tiny(tmp_path)
