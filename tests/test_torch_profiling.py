"""``infercnvpy_tpu_torch.profiling`` (counterpart of ``tests/test_profiling.py``).

On the CPU ``trace`` records host activity only; the tests check that a
Chrome trace is written, that ``annotate`` regions land in it, and the
``INFERCNVPY_TPU_TRACE_DIR`` switch of ``maybe_trace`` and ``tl.infercnv``,
whose capture carries the call's stage spans (``tests/test_torch_spans.py``
tests the spans themselves).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import infercnvpy_tpu_torch as tcnv  # noqa: E402
from infercnvpy_tpu_torch import profiling  # noqa: E402


def _names(trace_dir) -> set:
    events = json.loads((Path(trace_dir) / profiling.TRACE_FILE).read_text())["traceEvents"]
    return {e.get("name") for e in events}


def test_trace_writes_chrome_trace_with_annotations(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(logdir) as d:
        assert d == str(logdir)
        with profiling.annotate("matmul-region"):
            a = torch.ones((64, 64))
            float((a @ a).sum())
    assert profiling.last_trace_dir == str(logdir)
    assert "matmul-region" in _names(logdir)


def test_maybe_trace_noop_without_env(monkeypatch):
    monkeypatch.delenv("INFERCNVPY_TPU_TRACE_DIR", raising=False)
    with profiling.maybe_trace("stage") as d:
        assert d is None


def test_maybe_trace_imports_nothing_without_env():
    code = (
        "import os, sys; os.environ.pop('INFERCNVPY_TPU_TRACE_DIR', None); "
        "from infercnvpy_tpu_torch import profiling; before = set(sys.modules); "
        "ctx = profiling.maybe_trace('x'); ctx.__enter__(); ctx.__exit__(None, None, None); "
        "new = set(sys.modules) - before; assert not new, sorted(new)"
    )
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300)


def test_maybe_trace_env_driven(tmp_path, monkeypatch):
    monkeypatch.setenv("INFERCNVPY_TPU_TRACE_DIR", str(tmp_path))
    with profiling.maybe_trace("unit") as d:
        assert d is not None and d.startswith(str(tmp_path))
        float(torch.sin(torch.ones(8)).sum())
    entries = list(tmp_path.iterdir())
    assert len(entries) == 1 and entries[0].name.startswith("unit-")
    assert (entries[0] / profiling.TRACE_FILE).exists()


def test_infercnv_call_traced(tmp_path, monkeypatch):
    adata = tcnv.datasets.synthetic_cnv_dataset(n_cells=40, n_genes=400, seed=0)
    monkeypatch.setenv("INFERCNVPY_TPU_TRACE_DIR", str(tmp_path))
    tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat="Oligodendrocytes (non-malignant)", device="cpu")
    captures = [p for p in tmp_path.iterdir() if p.name.startswith("infercnv-")]
    assert len(captures) == 1
    assert (captures[0] / profiling.TRACE_FILE).exists()


def test_infercnv_env_trace_carries_the_stage_spans(tmp_path, monkeypatch):
    adata = tcnv.datasets.synthetic_cnv_dataset(n_cells=40, n_genes=400, seed=0)
    monkeypatch.setenv("INFERCNVPY_TPU_TRACE_DIR", str(tmp_path))
    tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat="Oligodendrocytes (non-malignant)", device="cpu")
    (capture,) = [p for p in tmp_path.iterdir() if p.name.startswith("infercnv-")]
    assert profiling.last_trace_dir == str(capture)
    events = json.loads((capture / profiling.TRACE_FILE).read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == profiling.SPAN_CATEGORY]
    # the capture covers the whole call: the root span and the stages before the compute
    assert [e["name"] for e in spans if e["args"]["parent"] is None] == ["infercnv"]
    assert {"infercnv.reference", "infercnv.subset", "infercnv.plan", "infercnv.launch", "infercnv.csr"} <= {
        e["name"] for e in spans}
    assert [s.name for s in profiling.last_spans] == [e["name"] for e in spans]
