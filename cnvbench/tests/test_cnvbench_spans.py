"""The readers of the program's stage spans (``cnvbench/spans.py``, ``metrics/stage_s.*``, ``wait_s.*``,
``idle_unspanned_s``, ``pinned_alloc_mib``) on a span list and a trace worked out by hand."""

from __future__ import annotations

import pytest

from cnvbench import run, spec, tracefile
from infercnvpy_tpu_torch import profiling

SPAN_METRICS = ["stage_s.subset", "stage_s.reference", "stage_s.plan", "stage_s.setup", "stage_s.pack", "stage_s.csr",
                "wait_s.device", "wait_s.pack", "idle_unspanned_s", "pinned_alloc_mib"]
MAIN, PACKER = 11, 22


def _span(name, thread, start, end, id_, parent, call, attrs=None, counts=None):
    return profiling.Span(name, thread, float(start), float(end), id_, parent, call, attrs or {}, counts or {})


def _two_calls() -> list:
    """Two traced calls (ids 1 and 20), times in microseconds."""
    return [
        _span("infercnv", MAIN, 0, 1000, 1, None, 1),
        _span("infercnv.subset", MAIN, 10, 110, 2, 1, 1),
        _span("x", MAIN, 20, 50, 3, 2, 1),  # children of the subset on its thread overlap: they cover 20-70
        _span("y", MAIN, 40, 70, 4, 2, 1),
        _span("z", PACKER, 30, 100, 5, 2, 1),  # a child on another thread is not the subset's own time
        _span("infercnv.pack", PACKER, 100, 300, 6, 1, 1, counts={"pinned_bytes": 2**20}),
        _span("infercnv.wait", PACKER, 150, 200, 7, 6, 1, {"on": "copies"}),
        _span("infercnv.wait", MAIN, 120, 310, 8, 1, 1, {"on": "pack"}),
        _span("infercnv.wait", MAIN, 400, 420, 9, 1, 1, {"on": "compute"}),
        _span("infercnv.csr", MAIN, 500, 700, 10, 1, 1, counts={"pinned_bytes": 2**20}),
        _span("infercnv", MAIN, 2000, 2500, 20, None, 20),
        _span("infercnv.subset", MAIN, 2010, 2060, 21, 20, 20),
        _span("infercnv.wait", MAIN, 2100, 2130, 22, 20, 20, {"on": "copies"}),
    ]


def _run() -> run.Run:
    trace = tracefile.Trace(window=(0.0, 2500.0), calls=[(0.0, 1000.0), (2000.0, 2500.0)],
                            busy={0: [[300.0, 450.0]], 1: [[2200.0, 2300.0]]}, device_ops={}, kernels=[], n_devices=2)
    return run.Run(cell=None, trace=trace)


def _read(name: str):
    return spec.metric_reader(name).read(_run())


@pytest.fixture
def two_calls(monkeypatch):
    monkeypatch.setattr(profiling, "last_spans", _two_calls())


@pytest.mark.parametrize("name, want_us", [
    ("stage_s.subset", (100 - 50 + 50) / 2),  # self time: 100 less 20-70 of its own thread; call 2 has no children
    ("stage_s.pack", (200 - 50) / 2),  # less its wait for the copies
    ("stage_s.csr", 200 / 2),
    ("stage_s.reference", 0.0),
    ("wait_s.device", (50 + 20 + 30) / 2),  # on "copies" or "compute", either thread
    ("wait_s.pack", 190 / 2),
])
def test_stage_and_wait_readers_per_call(two_calls, name, want_us):
    assert _read(name) == pytest.approx(want_us * 1e-6, abs=1e-12)


def test_pinned_alloc_mib_sums_the_counter_per_call(two_calls):
    assert _read("pinned_alloc_mib") == pytest.approx(1.0)


def test_idle_unspanned_s_by_hand(two_calls):
    # non-root spans cover 10-310, 400-420, 500-700, 2010-2060, 2100-2130; the devices 300-450 and 2200-2300:
    # together 10-450, 500-700, 2010-2060, 2100-2130, 2200-2300 = 820 us of the 2,500 us window
    assert _read("idle_unspanned_s") == pytest.approx((2500 - 820) / 2 * 1e-6)


def test_self_time_clips_children_to_the_span():
    parent = _span("p", MAIN, 100, 200, 1, None, 1)
    kids = {1: [_span("c", MAIN, 50, 150, 2, 1, 1), _span("d", MAIN, 180, 260, 3, 1, 1)]}
    from cnvbench import spans

    assert spans.self_us(parent, kids) == pytest.approx(100 - 50 - 20)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_readers_say_nothing_without_spans(monkeypatch, name):
    # a program without the recorder (the attribute missing), one that recorded nothing, one without a root span
    monkeypatch.delattr(profiling, "last_spans")
    assert _read(name) is None
    monkeypatch.setattr(profiling, "last_spans", [], raising=False)
    assert _read(name) is None
    monkeypatch.setattr(profiling, "last_spans", [_span("infercnv.csr", MAIN, 0, 1, 1, None, 1)])
    assert _read(name) is None


def test_idle_unspanned_s_needs_a_trace(two_calls):
    assert spec.metric_reader("idle_unspanned_s").read(run.Run(cell=None)) is None


def test_span_metrics_are_declared_with_their_cells():
    bench = spec.load_benchmark(spec.ROOT.parent)
    declared = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"] for w in bench["workloads"]}
    for name in SPAN_METRICS:
        m = declared[name]
        assert m["source"] == "program_span" and m["moves"] == "cnv_cells_per_s"
        assert set(m["workloads"]) <= cells
        assert (spec.ROOT / "metrics" / f"{name}.py").exists()
    assert "cohort_samples.windows" not in declared["wait_s.pack"]["workloads"]
