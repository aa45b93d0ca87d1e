"""The stage spans and counters of ``infercnvpy_tpu_torch.profiling`` and of ``tl.infercnv``.

Spans record only while ``profiling.trace`` runs, on every thread, and land
in the capture's ``trace.json`` (category ``program_span``) on the
profiler's clock and in ``profiling.last_spans``.  Needs neither JAX nor
the JAX package, so it also runs on the card:

    python -m pytest tests/test_torch_spans.py --noconftest -p no:cacheprovider
"""

import json
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import infercnvpy_tpu_torch as tcnv  # noqa: E402
from infercnvpy_tpu_torch import profiling  # noqa: E402
from infercnvpy_tpu_torch.tl._infercnv import _get_reference, _infercnv_compute  # noqa: E402

REF_CAT = "Oligodendrocytes (non-malignant)"
#: every stage span of a CPU call (``infercnv.wait`` on "copies" waits for CUDA events, so only on a card)
STAGES = {
    "infercnv", "infercnv.reference", "infercnv.subset", "infercnv.plan", "infercnv.setup", "infercnv.slots",
    "infercnv.pack", "infercnv.h2d", "infercnv.launch", "infercnv.d2h", "infercnv.csr", "infercnv.stack",
    "infercnv.gene_unpack", "infercnv.checkpoint", "infercnv.resume", "infercnv.gene_scatter",
    "infercnv.gene_reindex", "infercnv.wait",
}


def _events(trace_dir) -> list:
    return json.loads((Path(trace_dir) / profiling.TRACE_FILE).read_text())["traceEvents"]


def _program_spans(trace_dir) -> list:
    return [e for e in _events(trace_dir) if e.get("cat") == profiling.SPAN_CATEGORY]


def test_recording_off_records_nothing(tmp_path):
    off = profiling.span("a")
    assert off is profiling.span("b", on="pack") is profiling.span("c", parent=None)
    with off as entered:
        assert entered is off
        profiling.count("n", 1)
        assert profiling.current() is None
    with profiling.trace(tmp_path):
        with profiling.span("inside"):
            pass
    assert [s.name for s in profiling.last_spans] == ["inside"]
    with profiling.span("after"):
        pass
    assert [s.name for s in profiling.last_spans] == ["inside"]


def test_spans_of_main_and_worker_threads_reach_the_trace(tmp_path):
    def work(parent):
        with profiling.span("handed", parent=parent, batch=3):
            with profiling.span("nested"):
                profiling.count("bytes", 5)
        with profiling.span("orphan"):  # no parent given: threads do not inherit a stack
            pass
        return threading.get_native_id()

    with profiling.trace(tmp_path):
        with profiling.span("outer", tag="t"):
            parent = profiling.current()
            with ThreadPoolExecutor(max_workers=1) as pool:
                worker = pool.submit(work, parent).result(timeout=60)
            with profiling.span("inner"):
                profiling.count("n", 3)
                profiling.count("n", 4)
    by = {s.name: s for s in profiling.last_spans}
    assert set(by) == {"outer", "handed", "nested", "orphan", "inner"}
    outer = by["outer"]
    main = threading.get_native_id()
    assert outer.parent is None and outer.call == outer.id and outer.attrs == {"tag": "t"}
    assert by["handed"].parent == outer.id and by["handed"].call == outer.id and by["handed"].thread == worker != main
    assert by["nested"].parent == by["handed"].id and by["nested"].call == outer.id and by["nested"].thread == worker
    assert by["orphan"].parent is None and by["orphan"].call == by["orphan"].id
    assert by["inner"].parent == outer.id and by["inner"].thread == main and by["inner"].counts == {"n": 7}
    assert by["nested"].counts == {"bytes": 5} and by["handed"].attrs == {"batch": 3}
    assert all(s.start <= s.end for s in by.values())

    events = {e["name"]: e for e in _program_spans(tmp_path)}
    assert set(events) == set(by)
    for name, s in by.items():
        e = events[name]
        assert (e["args"]["id"], e["args"]["parent"], e["args"]["call"]) == (s.id, s.parent, s.call)
        assert e["ts"] == pytest.approx(s.start) and e["dur"] == pytest.approx(s.end - s.start)
    assert events["inner"]["args"]["counts"] == {"n": 7} and events["handed"]["args"]["batch"] == 3
    assert events["handed"]["tid"] == events["nested"]["tid"] != events["outer"]["tid"]
    tracks = {e["tid"]: e["args"]["name"] for e in _events(tmp_path) if e.get("ph") == "M"
              and e.get("name") == "thread_name" and e.get("tid") in {events[n]["tid"] for n in events}}
    assert len(tracks) == 2 and all(label.startswith("spans: ") for label in tracks.values())


def test_span_lines_up_with_a_profiler_region(tmp_path):
    with torch.profiler.record_function("warm-up"):
        pass
    trials = 5
    with profiling.trace(tmp_path):
        for i in range(trials):
            with profiling.span(f"aligned{i}"), torch.profiler.record_function(f"region{i}"):
                float(torch.ones((64, 64)).sum())
    events = _events(tmp_path)
    gaps = []
    for i in range(trials):
        region = next(e for e in events if e.get("name") == f"region{i}" and e.get("cat") == "user_annotation")
        span = next(e for e in events if e.get("name") == f"aligned{i}" and e.get("cat") == profiling.SPAN_CATEGORY)
        start_gap = region["ts"] - span["ts"]
        end_gap = (span["ts"] + span["dur"]) - (region["ts"] + region["dur"])
        gaps.append(max(abs(start_gap), abs(end_gap)))
    # the span encloses the region: each end differs by the region's enter or exit cost alone (the best of the
    # trials, so that a loaded host's stall in one of them does not decide)
    assert min(gaps) < 100.0, gaps


def _dataset(n_cells=240, n_genes=800):
    return tcnv.datasets.synthetic_cnv_dataset(n_cells=n_cells, n_genes=n_genes, seed=0)


KW = dict(reference_key="cell_type", reference_cat=REF_CAT, device="cpu", chunksize=40, batch_cells=80)


def test_infercnv_stage_spans_on_every_thread(tmp_path):
    adata = _dataset()
    ckpt = tmp_path / "ckpt"
    with profiling.trace(tmp_path / "trace"):
        tcnv.tl.infercnv(adata, **KW)  # three batches, pipelined
        tcnv.tl.infercnv(adata, **KW, calculate_gene_values=True, checkpoint_dir=ckpt)
        next(iter(sorted(ckpt.glob("batch_*.npz")))).unlink()
        tcnv.tl.infercnv(adata, **KW, calculate_gene_values=True, checkpoint_dir=ckpt)  # resumes two of three
    found = profiling.last_spans
    roots = [s for s in found if s.parent is None]
    assert [s.name for s in roots] == ["infercnv"] * 3
    assert roots[0].attrs == {"cells": 240, "genes": 800, "devices": 1}
    assert {s.name for s in found} == STAGES
    assert {s.attrs["on"] for s in found if s.name == "infercnv.wait"} == {"pack", "compute"}
    main = threading.get_native_id()
    first = roots[0].id
    packs = [s for s in found if s.name == "infercnv.pack" and s.call == first]
    assert len(packs) == 3 and all(s.thread != main and s.parent == first for s in packs)
    assert all(s.thread == main for s in found if s.name not in ("infercnv.pack", "infercnv.h2d"))
    assert all(s.call == r.id for r in roots for s in found if r.start <= s.start and s.end <= r.end)
    assert [s.name for s in found if s.call == roots[2].id].count("infercnv.resume") == 2
    by_id = {s.id: s for s in found}
    assert by_id[next(s.parent for s in found if s.name == "infercnv.slots")].name == "infercnv.setup"
    assert {e["name"] for e in _program_spans(tmp_path / "trace")} == STAGES


def test_infercnv_h2d_bytes_counter_equals_the_stage_clock(tmp_path):
    adata = _dataset()
    with profiling.trace(tmp_path):
        tcnv.tl.infercnv(adata, **KW)
    counted = sum(s.counts.get("h2d_bytes", 0) for s in profiling.last_spans)
    d2h = sum(s.counts.get("d2h_bytes", 0) for s in profiling.last_spans)
    assert [s.name for s in profiling.last_spans if "h2d_bytes" in s.counts] == ["infercnv.h2d"] * 3
    assert sum(s.counts.get("pinned_bytes", 0) for s in profiling.last_spans) == 0  # nothing is pinned on the CPU

    keep = adata.var["chromosome"].notnull() & ~adata.var["chromosome"].isin(["chrX", "chrY"])
    keep = keep.to_numpy()
    ref = _get_reference(adata, "cell_type", REF_CAT, None, None)[:, keep]
    stats: dict = {}
    _infercnv_compute(adata.X[:, np.flatnonzero(keep)], adata.var.loc[keep, ["chromosome", "start", "end"]],
                      np.asarray(ref, dtype=np.float64), lfc_clip=3, window_size=100, step=10, dynamic_threshold=1.5,
                      chunksize=40, batch_cells=80, dtype=None, device=torch.device("cpu"), stats=stats)
    assert counted == stats["h2d_bytes"] > 0
    assert d2h == stats["d2h_bytes"] > 0
