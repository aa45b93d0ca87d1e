"""The downstream cell on the CPU: a sound run is correct, planted faults read over their limits, the readers.

A cut of the cell's configuration (700 cells × 4,000 genes) runs the cell's
whole path through ``run.run_cell(..., device="cpu")``: set-up with
``tl.infercnv``, a window of chains, the stage-by-stage comparison.  Each
planted fault breaks the chain where it is produced and must read over the
limit of the number that holds that stage, so that the run reports
``correct: false``; a graph over ``conn_err`` is another deployment, so
set-up ends the run there, without a result:

* the JAX package's self-counting sigma in the port's graph → ``conn_err``;
* a community given the cells of another that no edge joins to it, a
  community in two disconnected parts → ``leiden_disconnected``;
* Leiden's labels shuffled → ``leiden_quality_short``;
* ``X_cnv`` rounded through bfloat16 before the PCA → ``pca_sval_err``,
  ``pca_energy_gap`` or ``pca_proj_err``;
* UMAP's epochs skipped, the spectral start returned → ``umap_ce_vs_start``;
* the layout permuted within each Leiden community, or whole →
  ``umap_ce_vs_shuffled``;
* a layout's rows permuted → ``umap_lost`` too.  Its limit is set for the
  atlas, where chance keeps 14 of 102,400 cells; at 700 cells chance keeps
  2 %, so this one is planted in 20,000 points and read directly.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from cnvbench import run, spec, tracefile
from infercnvpy_tpu_torch import profiling

CELL = "tiny.downstream"
SEED = 2**31 + 41


def write_tiny_downstream(root):
    """A checkout-like ``root`` whose ``BENCHMARK.json`` names one cell ``tiny.downstream``: the cell's
    configuration cut to 700 cells × 4,000 genes under the traffic ``downstream``; returns the folder of the
    added configuration."""
    base = root / "bench"
    (base / "configs").mkdir(parents=True)
    config = json.loads((spec.ROOT / "configs" / "atlas_102k_downstream.json").read_text())
    config["genome"]["n_genes"] = 4000
    config["samples"] = {"count": 1, "cells_min": 700, "cells_max": 700}
    (base / "configs" / "tiny.json").write_text(json.dumps(config))
    bench = json.loads((spec.ROOT.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "bench/configs/tiny.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = [{"name": CELL, "config": "tiny", "traffic": "downstream", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL] if "atlas_102k.downstream" in m["workloads"] else []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


@pytest.fixture(scope="module")
def torch_threads():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(tmp_path):
    base = write_tiny_downstream(tmp_path)
    code, result = run.run_cell(tmp_path, CELL, SEED, 0.2, 0, device="cpu", bases=(base, spec.ROOT))
    assert code == 0
    return result


def test_sound_run_is_correct(tmp_path, torch_threads):
    result = _run(tmp_path)
    assert result["correct"] is True, result["compared"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"cnv_cells_per_s", "setup_s"}  # peak_device_gib: no card
    assert set(result["compared"]) == set(spec.driver("downstream_chain").Driver.limits)


def _self_counting_sigma(monkeypatch):
    from cnvbench.reference import downstream as ref
    from infercnvpy_tpu_torch.ops import graph

    monkeypatch.setattr(graph, "_smooth_knn_dist", lambda d, lc: ref.smooth_knn_dist(d, lc, count_self=True))


def _relabel(monkeypatch, change):
    from infercnvpy_tpu_torch.ops import leiden

    clustered = leiden.leiden

    def faulty(adjacency, *args, **kw):
        return change(adjacency, clustered(adjacency, *args, **kw))

    monkeypatch.setattr(leiden, "leiden", faulty)


def _join_two_apart(adjacency, labels):
    """Community 0 takes the cells of community 1 that no edge joins to it: a community in two parts."""
    A = adjacency.tocoo()
    touching = np.zeros(len(labels), dtype=bool)
    touching[A.row[labels[A.col] == 0]] = True
    return np.where((labels == 1) & ~touching, 0, labels)


def _shuffled(adjacency, labels):
    return np.random.default_rng(0).permutation(labels)


def _bf16_x_cnv(monkeypatch):
    import torch

    from infercnvpy_tpu_torch.ops import linalg

    svd = linalg.truncated_svd

    def rounded(X, *args, **kw):
        X = X.copy()
        X.data = torch.from_numpy(np.ascontiguousarray(X.data)).to(torch.bfloat16).float().numpy()
        return svd(X, *args, **kw)

    monkeypatch.setattr(linalg, "truncated_svd", rounded)


def _epochs_skipped(monkeypatch):
    from infercnvpy_tpu_torch.ops import umap_

    monkeypatch.setattr(umap_, "_optimize", lambda emb, *args: emb)


def _moved_layout(monkeypatch, move):
    """``tl.umap`` followed by ``move(layout, Leiden labels)``."""
    import infercnvpy_tpu_torch as tcnv

    umap = tcnv.tl.umap

    def faulty(adata, *args, **kw):
        umap(adata, *args, **kw)
        labels = np.unique(np.asarray(adata.obs["cnv_leiden"]).astype(str), return_inverse=True)[1]
        adata.obsm["X_cnv_umap"] = move(adata.obsm["X_cnv_umap"], labels)

    monkeypatch.setattr(tcnv.tl, "umap", faulty)


def _within_communities(layout, labels):
    from cnvbench.reference import downstream as ref

    return ref.shuffle_within(layout, labels, seed=11)


FAULTS = {
    "self_counting_sigma": (_self_counting_sigma, ["conn_err"]),
    "community_in_two_halves": (lambda mp: _relabel(mp, _join_two_apart), ["leiden_disconnected"]),
    "labels_shuffled": (lambda mp: _relabel(mp, _shuffled), ["leiden_quality_short"]),
    "x_cnv_through_bfloat16": (_bf16_x_cnv, ["pca_sval_err", "pca_energy_gap", "pca_proj_err"]),
    "umap_epochs_skipped": (_epochs_skipped, ["umap_ce_vs_start"]),
    "layout_within_communities": (lambda mp: _moved_layout(mp, _within_communities), ["umap_ce_vs_shuffled"]),
    "layout_permuted": (lambda mp: _moved_layout(mp, lambda y, _: np.random.default_rng(0).permutation(y)),
                        ["umap_ce_vs_shuffled"]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_reads_over_its_limit(tmp_path, monkeypatch, torch_threads, fault):
    plant, numbers = FAULTS[fault]
    plant(monkeypatch)
    if numbers == ["conn_err"]:
        with pytest.raises(RuntimeError, match="reads conn_err .* over its limit"):
            _run(tmp_path)
        return
    result = _run(tmp_path)
    assert result["correct"] is False and result["failed"] == result["attempted"] >= 1
    assert any(result["compared"][k]["value"] > result["compared"][k]["limit"] for k in numbers), result["compared"]


def test_a_fault_after_set_up_reads_false(tmp_path, monkeypatch, torch_threads):
    """A chain that goes wrong only after set-up's warm-up chain: the window's outputs are compared all the same."""
    from infercnvpy_tpu_torch.ops import leiden

    clustered, calls = leiden.leiden, []

    def later_shuffled(adjacency, *args, **kw):
        calls.append(1)
        labels = clustered(adjacency, *args, **kw)
        return labels if len(calls) == 1 else _shuffled(adjacency, labels)

    monkeypatch.setattr(leiden, "leiden", later_shuffled)
    result = _run(tmp_path)
    assert result["correct"] is False and result["failed"] == result["attempted"] >= 1
    assert result["compared"]["leiden_quality_short"]["value"] > result["compared"]["leiden_quality_short"]["limit"]


def test_permuted_layout_reads_over_the_limit():
    """20,000 points in 3-D, their 14 nearest as the graph: the first two coordinates keep neighbours, the same
    layout with its rows permuted keeps what chance keeps, 14 of 20,000, and reads over ``umap_lost``'s limit."""
    from cnvbench.reference import downstream as ref
    from cnvbench.reference.downstream_compare import LIMITS

    points = np.random.default_rng(5).normal(size=(20_000, 3))
    _, graph = ref.exact_knn(points, 14, "cpu")
    kept = ref.neighbour_retention(points[:, :2], graph, "cpu")
    lost = 1.0 - ref.neighbour_retention(np.random.default_rng(6).permutation(points[:, :2]), graph, "cpu")
    assert 1.0 - kept < LIMITS["umap_lost"] < lost, (kept, lost)


# ----- the readers of the chain's spans ----------------------------------------------------------------------

CHAIN_READERS = {"stage_s.pca": "pca", "stage_s.knn": "neighbors.knn",
                 "stage_s.connectivities": "neighbors.connectivities", "stage_s.leiden": "leiden",
                 "stage_s.umap_init": "umap.init", "stage_s.umap_epochs": "umap.epochs"}


def _span(name, start, end, id_, parent, counts=None):
    return profiling.Span(name, 7, float(start), float(end), id_, parent, id_ if parent is None else parent, {},
                          counts or {})


def _two_chains() -> list:
    """Two traced chains; times in microseconds, each stage's span 100 us in the first chain, 300 in the second."""
    out = []
    for c, t0 in ((0, 0.0), (1, 1e6)):
        width = 100 * (1 + 2 * c)
        i = 100 * c
        out += [_span("pca", t0, t0 + width, i + 1, None),
                _span("neighbors", t0 + 1e3, t0 + 1e3 + 2 * width, i + 2, None),
                _span("neighbors.knn", t0 + 1e3, t0 + 1e3 + width, i + 3, i + 2, {"knn_flops": 6.7e9}),
                _span("neighbors.connectivities", t0 + 1e3 + width, t0 + 1e3 + 2 * width, i + 4, i + 2),
                _span("leiden", t0 + 2e3, t0 + 2e3 + width, i + 5, None, {"leiden_communities": 40}),
                _span("umap", t0 + 3e3, t0 + 3e3 + 2 * width, i + 6, None),
                _span("umap.init", t0 + 3e3, t0 + 3e3 + width, i + 7, i + 6),
                _span("umap.epochs", t0 + 3e3 + width, t0 + 3e3 + 2 * width, i + 8, i + 6, {"umap_edges": 9})]
    return out


def _traced_run() -> run.Run:
    trace = tracefile.Trace(window=(0.0, 2e6), calls=[(0.0, 1e6), (1e6, 2e6)], busy={0: [[0.0, 5e5]]},
                            device_ops={}, kernels=[], n_devices=1)
    return run.Run(cell=None, trace=trace)


@pytest.mark.parametrize("metric", sorted(CHAIN_READERS))
def test_chain_stage_readers_by_hand(monkeypatch, metric):
    monkeypatch.setattr(profiling, "last_spans", _two_chains())
    assert spec.metric_reader(metric).read(_traced_run()) == pytest.approx((100 + 300) / 2 / 1e6)


def test_knn_roofline_and_idle_by_hand(monkeypatch):
    monkeypatch.setattr(profiling, "last_spans", _two_chains())
    # 2 x 6.7e9 operations in 400 us at 67e12 operations a second
    assert spec.metric_reader("knn_roofline").read(_traced_run()) == pytest.approx(100 * 2 * 6.7e9 / 400e-6 / 67e12)
    assert spec.metric_reader("device_idle.downstream").read(_traced_run()) == pytest.approx(75.0)


@pytest.mark.parametrize("metric", sorted(CHAIN_READERS) + ["knn_roofline"])
def test_chain_readers_say_nothing_without_spans(monkeypatch, metric):
    """The parent records no chain spans: no reading, and nothing raised; nor without a trace."""
    monkeypatch.setattr(profiling, "last_spans", [_span("infercnv", 0, 10, 1, None)])
    assert spec.metric_reader(metric).read(_traced_run()) is None
    monkeypatch.setattr(profiling, "last_spans", _two_chains())
    assert spec.metric_reader(metric).read(run.Run(cell=None)) is None
