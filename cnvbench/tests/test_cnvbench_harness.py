"""The harness on the CPU: files found by name, seeded generators, the result line, the readers, the guards."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cnvbench import data, guard, run, spec, tracefile
from cnvbench.tests.conftest import write_tiny

REPO = spec.ROOT.parent
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    base = write_tiny(tmp_path, metrics=[{"name": "calls_made", "unit": "calls", "better": "higher", "bound": 0.25,
                                          "source": "host_clock"}])
    (base / "metrics" / "calls_made.py").write_text("def read(run):\n    return float(len(run.calls))\n")
    code, result = run.run_cell(tmp_path, "tiny.small", 5, 0.5, 0, device="cpu", bases=(base, spec.ROOT))
    assert code == 0
    assert result["metrics"]["calls_made"] == {"value": float(result["attempted"]), "unit": "calls"}
    assert result["correct"] is True and result["failed"] == 0


def test_result_line_has_exactly_the_contract_keys(tiny):
    root, base = tiny
    code, result = run.run_cell(root, "tiny.small", 2**31 + 5, 0.5, 0, device="cpu", bases=(base, spec.ROOT))
    assert code == 0
    assert list(result) == RESULT_KEYS  # "compared" comes last
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in result["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_generators_repeat_per_seed():
    config = json.loads((spec.ROOT / "configs" / "cohort_samples.json").read_text())
    var = data.make_var(1500)
    a = data.make_sample(config, var, 600, 2**31 + 9, 3, "cpu")
    b = data.make_sample(config, var, 600, 2**31 + 9, 3, "cpu")
    c = data.make_sample(config, var, 600, 2**31 + 10, 3, "cpu")
    assert (a.X != b.X).nnz == 0 and list(a.labels) == list(b.labels)
    assert (a.X != c.X).nnz > 0
    assert sorted(a.labels) == sorted(c.labels)  # the seed orders the cells; the counts are fixed
    assert data.make_var(1500).equals(var)
    sizes = data.sample_sizes(config)
    assert len(sizes) == 32 and min(sizes) >= 500 and max(sizes) <= 6000
    assert 2000 <= np.mean(sizes) <= 2400


def test_k1_roofline_counts_bytes_by_hand():
    reader = spec.metric_reader("k1_roofline")
    launches = 7
    trace = tracefile.Trace(window=(0.0, 1e6), calls=[(0.0, 1e6)], busy={0: [[0.0, 1.0]]}, device_ops={},
                            kernels=[("fused_window_kernel<...>", 0.0, 1000.0)] * launches)
    run_ = run.Run(cell=None, trace=trace,
                   shapes={"cells": 102_400, "genes": 20_000, "windows": 1_793, "window_size": 100})
    # each cell's 20,000 genes read, its 1,793 windows and 3 row numbers written, f32; 2 reference rows a launch
    by_hand = 102_400 * (20_000 + 1_793 + 3) * 4 + launches * 2 * 20_000 * 4
    assert by_hand == 8_928_761_600
    want = by_hand / 3.35e12 / (launches * 1e-3) * 100
    assert reader.read(run_) == pytest.approx(want, rel=1e-12)


def test_k1_roofline_says_nothing_without_launches():
    reader = spec.metric_reader("k1_roofline")
    trace = tracefile.Trace(window=(0.0, 1.0), calls=[(0.0, 1.0)], busy={0: [[0.0, 1.0]]}, device_ops={}, kernels=[])
    assert reader.read(run.Run(cell=None, trace=trace, shapes={"cells": 1, "genes": 1, "windows": 1,
                                                               "window_size": 1})) is None


def test_no_jax_check():
    assert guard.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "infercnvpy_tpu",
                                    "infercnvpy_tpu.tl"]) == ["flax.linen", "infercnvpy_tpu", "infercnvpy_tpu.tl",
                                                              "jax", "jax.numpy", "jaxlib.xla"]
    assert guard.forbidden_modules(["infercnvpy_tpu_torch", "infercnvpy_tpu_torch.tl", "jaxtyping", "numpy"]) == []


def test_harness_loads_no_jax():
    code = ("import sys, json; from pathlib import Path; from cnvbench import run, guard; "
            "import cnvbench.drivers, cnvbench.reference.compare, cnvbench.calibrate; "
            "print(json.dumps(guard.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "cnvbench.run", "--workload", "atlas_102k.windows", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_trace_reduction():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "cnvbench.call", "ts": 100.0, "dur": 1000.0},
        {"ph": "X", "cat": "user_annotation", "name": "cnvbench.call", "ts": 1200.0, "dur": 800.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGetDevice", "ts": 110.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 400.0, "dur": 5.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 1300.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "fused_window_kernel", "ts": 500.0, "dur": 100.0, "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 550.0, "dur": 100.0, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 1500.0, "dur": 100.0, "args": {"device": 1}},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 5000.0, "dur": 100.0, "args": {"device": 0}},
    ]
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "trace.json"
        path.write_text(json.dumps({"traceEvents": events}))
        t = tracefile.read(path)
    assert t.window == (100.0, 2000.0)
    assert t.busy_s(0) == pytest.approx(150e-6) and t.busy_s(1) == pytest.approx(100e-6)
    assert t.idle_share() == pytest.approx(1 - (150 + 100) / 2 / 1900)
    assert tracefile.preludes(t) == pytest.approx([300e-6, 100e-6])
    assert [k[0] for k in t.kernels] == ["fused_window_kernel", "other"]
    samples = [(0.0, "a"), (0.0005, "b"), (0.001, "a"), (0.0015, "c")]  # perf seconds; offset maps 0 -> 100 us
    idle = tracefile.idle_by_host(t, samples, 100.0)
    # "a" at 100 us (idle, 0.5 ms to the next), "b" at 600 us (busy), "a" at 1100 us (idle); "c" has no next
    assert idle == pytest.approx({"a": 0.001})


def test_idle_share_counts_a_silent_device_as_idle():
    # two devices busy for 150 and 100 us of a 1,000 us window; the run used four, two of which did nothing
    trace = tracefile.Trace(window=(0.0, 1000.0), calls=[(0.0, 1000.0)],
                            busy={0: [[0.0, 150.0]], 1: [[500.0, 600.0]]}, device_ops={}, kernels=[], n_devices=4)
    assert trace.mean_busy_s() == pytest.approx(250e-6 / 4)
    assert trace.idle_share() == pytest.approx(1 - 250 / 4 / 1000)
    reader = spec.metric_reader("device_idle.infercnv")
    assert reader.read(run.Run(cell=None, trace=trace)) == pytest.approx(100 * (1 - 250 / 4 / 1000))


def test_spec_refuses_an_unknown_workload(tiny):
    root, base = tiny
    with pytest.raises(KeyError):
        spec.cell(spec.load_benchmark(root), "nope", root, (base, spec.ROOT))
