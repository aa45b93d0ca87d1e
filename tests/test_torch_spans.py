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
    assert {s.attrs["on"] for s in found if s.name == "infercnv.wait"} == {"pack", "compute", "memory"}
    main = threading.get_native_id()
    first = roots[0].id
    packs = [s for s in found if s.name == "infercnv.pack" and s.call == first]
    assert len(packs) == 3 and all(s.thread != main and s.parent == first for s in packs)
    memory_waits = [s for s in found if s.attrs.get("on") == "memory"]  # two pipelined calls, two later copies each
    assert len(memory_waits) == 4 and all(s.thread != main for s in memory_waits)
    assert all(s.thread == main for s in found
               if s.name not in ("infercnv.pack", "infercnv.h2d") and s not in memory_waits)
    assert all(s.call == r.id for r in roots for s in found if r.start <= s.start and s.end <= r.end)
    assert [s.name for s in found if s.call == roots[2].id].count("infercnv.resume") == 2
    by_id = {s.id: s for s in found}
    assert by_id[next(s.parent for s in found if s.name == "infercnv.slots")].name == "infercnv.setup"
    assert {e["name"] for e in _program_spans(tmp_path / "trace")} == STAGES


def test_infercnv_csr_spans_carry_the_fill_and_its_copies(tmp_path):
    """One ``infercnv.csr`` a batch, carrying its fill's thread count; ``csr_nnz`` counts the values the native
    fill wrote, all of ``X_cnv``'s on a packed call; ``csr_copied_bytes`` is 0 on a plain multi-batch call and
    counts the resumed batches' copies."""
    import infercnvpy_tpu_torch.tl._infercnv as drv

    adata = _dataset()
    kw = dict(KW, window_size=21, step=2)  # 172 windows: each batch comes packed
    ckpt = tmp_path / "ckpt"
    with profiling.trace(tmp_path / "trace"):
        tcnv.tl.infercnv(adata, **kw)  # three batches
        want = adata.obsm["X_cnv"]
        tcnv.tl.infercnv(adata, **kw, checkpoint_dir=ckpt)
        next(iter(sorted(ckpt.glob("batch_*.npz")))).unlink()
        tcnv.tl.infercnv(adata, **kw, checkpoint_dir=ckpt)  # resumes two of three
    found = profiling.last_spans
    roots = [s for s in found if s.parent is None]
    csr = [[s for s in found if s.name == "infercnv.csr" and s.call == r.id] for r in roots]
    assert [len(spans) for spans in csr] == [3, 3, 3]
    for spans in csr[:2]:
        assert sum(s.counts["csr_nnz"] for s in spans) == want.nnz > 0
        assert sum(s.counts["csr_copied_bytes"] for s in spans) == 0
        # the packer prepares the third batch while the first is filled, then has nothing left to pack
        assert [s.attrs for s in spans] == [{"threads": drv._csr_fill_threads(s.counts["csr_nnz"], beside)}
                                            for s, beside in zip(spans, (True, False, False))]
    resumed = [s for s in csr[2] if "csr_nnz" not in s.counts]
    assert len(resumed) == 2 and all(s.counts["csr_copied_bytes"] > 0 and s.attrs == {"threads": 1} for s in resumed)
    assert sum(s.counts.get("csr_nnz", 0) for s in csr[2]) == csr[0][0].counts["csr_nnz"]
    assert (adata.obsm["X_cnv"] != want).nnz == 0


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


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_infercnv_subset_span_counts_genes_and_copies(tmp_path, fmt):
    """``infercnv.subset`` carries the genes kept and dropped; ``subset_copy_bytes`` counts the expression bytes
    copied to select genes or change formats: none for CSR input, the converted matrix's for CSC."""
    adata = _dataset()
    if fmt == "csc":
        adata.X = adata.X.tocsc()
    keep = (adata.var["chromosome"].notnull() & ~adata.var["chromosome"].isin(["chrX", "chrY"])).to_numpy()
    with profiling.trace(tmp_path):
        tcnv.tl.infercnv(adata, **KW)
    subset = [s for s in profiling.last_spans if s.name == "infercnv.subset"]
    assert len(subset) == 1
    assert subset[0].attrs == {"genes_kept": int(keep.sum()), "genes_dropped": int((~keep).sum())}
    assert 0 < subset[0].attrs["genes_dropped"] < 800
    copied = sum(s.counts.get("subset_copy_bytes", 0) for s in profiling.last_spans)
    if fmt == "csr":
        assert copied == 0
    else:
        csr = adata.X.tocsr()
        assert copied == csr.data.nbytes + csr.indices.nbytes + csr.indptr.nbytes > 0
        assert subset[0].counts == {"subset_copy_bytes": copied}


def test_prefetched_copy_waits_for_the_previous_compute(tmp_path):
    """A pipelined batch's copy starts only after the previous batch's compute has returned (``infercnv.wait``
    ``on="memory"`` on the packer thread), so the device never holds the next batch's uploads beside the current
    batch's dense block."""
    with profiling.trace(tmp_path):
        tcnv.tl.infercnv(_dataset(), **KW)  # three batches, pipelined
    found = profiling.last_spans
    launches = sorted((s for s in found if s.name == "infercnv.launch"), key=lambda s: s.start)
    copies = sorted((s for s in found if s.name == "infercnv.h2d"), key=lambda s: s.start)
    waits = [s for s in found if s.name == "infercnv.wait" and s.attrs["on"] == "memory"]
    assert len(launches) == len(copies) == 3 and len(waits) == 2
    for launch, copy in zip(launches, copies[1:]):
        assert copy.start >= launch.end


def _census_run(case: str, tmp_path) -> list:
    """The spans of one traced call of ``case`` on ``_dataset()``'s three batches."""
    adata = _dataset()
    if case == "serialized":
        keep = (adata.var["chromosome"].notnull() & ~adata.var["chromosome"].isin(["chrX", "chrY"])).to_numpy()
        ref = _get_reference(adata, "cell_type", REF_CAT, None, None)[:, keep]
        with profiling.trace(tmp_path / "trace"):
            _infercnv_compute(adata.X[:, np.flatnonzero(keep)], adata.var.loc[keep, ["chromosome", "start", "end"]],
                              np.asarray(ref, dtype=np.float64), lfc_clip=3, window_size=100, step=10,
                              dynamic_threshold=1.5, chunksize=40, batch_cells=80, dtype=None,
                              device=torch.device("cpu"), stats={})
        return profiling.last_spans
    kw = dict(KW, device=["cpu", "cpu"]) if case == "two_devices" else KW
    if case == "resumed":
        kw = dict(KW, calculate_gene_values=True, checkpoint_dir=tmp_path / "ckpt")
        tcnv.tl.infercnv(adata, **kw)
        next(iter(sorted((tmp_path / "ckpt").glob("batch_*.npz")))).unlink()
    with profiling.trace(tmp_path / "trace"):
        tcnv.tl.infercnv(adata, **kw)
    return profiling.last_spans


def _census(spans: list) -> tuple[dict, dict]:
    """``({(name, on, "main" or "packer", parent's name): spans}, {counter: total})`` of a call's spans."""
    main = threading.get_native_id()
    names = {s.id: s.name for s in spans}
    shapes, counts = {}, {}
    for s in spans:
        key = (s.name, s.attrs.get("on"), "main" if s.thread == main else "packer", names.get(s.parent))
        shapes[key] = shapes.get(key, 0) + 1
        for name, n in s.counts.items():
            counts[name] = counts.get(name, 0) + n
    return shapes, counts


#: each case's span census and counter totals on the CPU, as recorded; a change to the batch loop leaves them as is
CENSUS = {
    "pipelined": (
        {("infercnv", None, "main", None): 1, ("infercnv.reference", None, "main", "infercnv"): 1,
         ("infercnv.subset", None, "main", "infercnv"): 1, ("infercnv.plan", None, "main", "infercnv"): 1,
         ("infercnv.setup", None, "main", "infercnv"): 1, ("infercnv.slots", None, "main", "infercnv.setup"): 1,
         ("infercnv.pack", None, "packer", "infercnv"): 3, ("infercnv.h2d", None, "packer", "infercnv"): 3,
         ("infercnv.wait", "memory", "packer", "infercnv"): 2, ("infercnv.wait", "pack", "main", "infercnv"): 3,
         ("infercnv.launch", None, "main", "infercnv"): 3,
         ("infercnv.wait", "compute", "main", "infercnv.launch"): 3, ("infercnv.d2h", None, "main", "infercnv"): 3,
         ("infercnv.csr", None, "main", "infercnv"): 3, ("infercnv.stack", None, "main", "infercnv"): 1},
        {"csr_copied_bytes": 0, "csr_nnz": 637, "d2h_bytes": 13248, "h2d_bytes": 18877248, "reference_nnz": 22668},
    ),
    "serialized": (
        {("infercnv.plan", None, "main", None): 1, ("infercnv.setup", None, "main", None): 1,
         ("infercnv.slots", None, "main", "infercnv.setup"): 1, ("infercnv.pack", None, "main", None): 3,
         ("infercnv.h2d", None, "main", None): 3, ("infercnv.launch", None, "main", None): 3,
         ("infercnv.wait", "compute", "main", "infercnv.launch"): 3, ("infercnv.d2h", None, "main", None): 3,
         ("infercnv.csr", None, "main", None): 3, ("infercnv.stack", None, "main", None): 1},
        {"csr_copied_bytes": 0, "csr_nnz": 637, "d2h_bytes": 13248, "h2d_bytes": 18877248},
    ),
    "resumed": (
        {("infercnv", None, "main", None): 1, ("infercnv.reference", None, "main", "infercnv"): 1,
         ("infercnv.subset", None, "main", "infercnv"): 1, ("infercnv.plan", None, "main", "infercnv"): 1,
         ("infercnv.setup", None, "main", "infercnv"): 1, ("infercnv.slots", None, "main", "infercnv.setup"): 1,
         ("infercnv.pack", None, "main", "infercnv"): 1, ("infercnv.h2d", None, "main", "infercnv"): 1,
         ("infercnv.launch", None, "main", "infercnv"): 1,
         ("infercnv.wait", "compute", "main", "infercnv.launch"): 2, ("infercnv.d2h", None, "main", "infercnv"): 1,
         ("infercnv.csr", None, "main", "infercnv"): 3, ("infercnv.gene_unpack", None, "main", "infercnv"): 1,
         ("infercnv.checkpoint", None, "main", "infercnv"): 1, ("infercnv.resume", None, "main", "infercnv"): 2,
         ("infercnv.stack", None, "main", "infercnv"): 1, ("infercnv.gene_scatter", None, "main", "infercnv"): 1,
         ("infercnv.gene_reindex", None, "main", "infercnv"): 1},
        {"csr_copied_bytes": 4088, "csr_nnz": 206, "d2h_bytes": 4416, "gene_d2h_bytes": 40448,
         "h2d_bytes": 6292416, "reference_nnz": 22668, "subset_copy_bytes": 840676},
    ),
    "two_devices": (
        {("infercnv", None, "main", None): 1, ("infercnv.reference", None, "main", "infercnv"): 1,
         ("infercnv.subset", None, "main", "infercnv"): 1, ("infercnv.plan", None, "main", "infercnv"): 1,
         ("infercnv.setup", None, "main", "infercnv"): 1, ("infercnv.slots", None, "main", "infercnv.setup"): 1,
         ("infercnv.pack", None, "packer", "infercnv"): 3, ("infercnv.h2d", None, "packer", "infercnv"): 3,
         ("infercnv.wait", "memory", "packer", "infercnv"): 2, ("infercnv.wait", "pack", "main", "infercnv"): 3,
         ("infercnv.launch", None, "main", "infercnv"): 3,
         ("infercnv.wait", "compute", "main", "infercnv.launch"): 3, ("infercnv.d2h", None, "main", "infercnv"): 3,
         ("infercnv.csr", None, "main", "infercnv"): 3, ("infercnv.stack", None, "main", "infercnv"): 1},
        {"csr_copied_bytes": 6056, "csr_nnz": 0, "d2h_bytes": 21120, "h2d_bytes": 710400, "reference_nnz": 22668},
    ),
}


@pytest.mark.parametrize("case", ["pipelined", "serialized", "resumed", "two_devices"])
def test_infercnv_span_census(tmp_path, case):
    """Each call opens the same spans, on the same threads under the same parents, with the same counter totals:
    three batches pipelined, the same three serialized by ``stats``, two of three resumed with gene values, and
    two cell shards; the reference means come from the native pass over the reference category's values."""
    spans = _census_run(case, tmp_path)
    shapes, counts = _census(spans)
    assert (shapes, counts) == CENSUS[case]
    adata = _dataset()
    nnz = int(np.diff(adata.X.indptr)[adata.obs["cell_type"].to_numpy() == REF_CAT].sum())
    reference = [(s.attrs, s.counts) for s in spans if s.name == "infercnv.reference"]
    want = [({"path": "native", "categories": 1}, {"reference_nnz": nnz})] if case != "serialized" else []
    assert reference == want


def test_a_failed_batch_does_not_leave_the_packer_waiting(monkeypatch):
    """The packer thread waits for the previous batch's compute; when that compute raises, the call raises too
    and returns."""
    import infercnvpy_tpu_torch.tl._infercnv as drv

    def failing(*a, **k):
        def run(*args):
            raise RuntimeError("planted failure")

        return run

    monkeypatch.setattr(drv, "sharded_infercnv_fn", failing)
    raised = []

    def call():
        try:
            tcnv.tl.infercnv(_dataset(), **KW)
        except RuntimeError as e:
            raised.append(str(e))

    worker = threading.Thread(target=call, daemon=True)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    assert raised == ["planted failure"]


# ----- the downstream chain --------------------------------------------------------------------------------

#: root span -> its attrs for a chain on ``_chain_input()``'s 300 cells; and each child's root
CHAIN_ROOTS = {"pca": {"cells": 300, "comps": 20}, "neighbors": {"cells": 300, "k": 15}, "leiden": {"cells": 300},
               "cnv_score": {"cells": 300}, "umap": {"cells": 300}}
CHAIN_CHILDREN = {"neighbors.knn": "neighbors", "neighbors.connectivities": "neighbors", "umap.init": "umap",
                  "umap.epochs": "umap"}


def _chain_input():
    """A fresh AnnData holding a 300 × 40 CSR ``X_cnv`` of three groups."""
    import pandas as pd
    import scipy.sparse as sp

    rng = np.random.default_rng(3)
    centres = rng.normal(scale=3.0, size=(3, 40))
    x = centres[np.repeat(np.arange(3), 100)] + rng.normal(size=(300, 40))
    x[np.abs(x) < 1.0] = 0.0
    obs = pd.DataFrame({"cell_type": np.repeat(["a", "b", "c"], 100)}, index=[f"c{i}" for i in range(300)])
    return tcnv.AnnData(obs=obs, obsm={"X_cnv": sp.csr_matrix(x.astype(np.float32))})


def _chain(adata):
    tcnv.tl.pca(adata, device="cpu", n_comps=20)
    tcnv.pp.neighbors(adata, device="cpu")
    tcnv.tl.leiden(adata)
    tcnv.tl.cnv_score(adata, device="cpu")
    tcnv.tl.umap(adata, device="cpu", n_epochs=20)


def test_chain_spans_and_counters_under_trace(tmp_path):
    from infercnvpy_tpu_torch.ops.umap_ import _select_edges

    adata = _chain_input()
    with profiling.trace(tmp_path):
        _chain(adata)
    found = profiling.last_spans
    roots = {s.name: s for s in found if s.parent is None}
    assert list(roots) == list(CHAIN_ROOTS)
    assert {name: s.attrs for name, s in roots.items()} == CHAIN_ROOTS
    kids = {s.name: s for s in found if s.parent is not None}
    assert set(kids) == set(CHAIN_CHILDREN)
    for name, root in CHAIN_CHILDREN.items():
        assert kids[name].parent == roots[root].id and kids[name].call == roots[root].id
        assert roots[root].start <= kids[name].start <= kids[name].end <= roots[root].end
    assert kids["neighbors.knn"].counts == {"knn_flops": 2 * 300 * 300 * 20}
    assert roots["leiden"].counts == {"leiden_communities": adata.obs["cnv_leiden"].nunique()}
    edges = len(_select_edges(adata.obsp["cnv_neighbors_connectivities"].tocoo(), 20)[0])
    assert kids["umap.epochs"].counts == {"umap_edges": edges} and edges > 300
    assert {e["name"] for e in _program_spans(tmp_path)} == set(CHAIN_ROOTS) | set(CHAIN_CHILDREN)


@pytest.mark.parametrize("block,shards", [(4096, 1), (64, 1), (64, 3)])
def test_knn_flops_is_two_n_squared_d(tmp_path, block, shards):
    from infercnvpy_tpu_torch.ops.knn import exact_knn

    x = np.random.default_rng(0).normal(size=(250, 12)).astype(np.float32)
    with profiling.trace(tmp_path), profiling.span("root"):
        exact_knn(x, 15, block=block, device=["cpu"] * shards if shards > 1 else "cpu")
    assert [s.counts for s in profiling.last_spans] == [{"knn_flops": 2 * 250 * 250 * 12}]


def test_the_untraced_chain_records_nothing(tmp_path):
    with profiling.trace(tmp_path), profiling.span("before"):
        pass
    kept, records = list(profiling.last_spans), len(profiling._records)
    _chain(_chain_input())
    assert profiling.last_spans == kept and len(profiling._records) == records
    assert profiling.current() is None
