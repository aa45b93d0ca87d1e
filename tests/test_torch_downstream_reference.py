"""The port's downstream chain against the benchmark's plain float64 reference (``cnvbench/reference/downstream.py``).

A cut of the downstream cell's configuration (2,000 cells × 6,000 genes,
seeded, from ``cnvbench/data.py``) goes through the port's ``tl.infercnv`` on
the CPU, then ``tl.pca`` → ``pp.neighbors`` → ``tl.leiden`` →
``tl.cnv_score`` → ``tl.umap`` with the configuration's parameters, which are
the entry points' defaults (a test here holds them so).  Each stage is held against the reference
fed the port's own input to that stage, as the benchmark's cell compares
them (``cnvbench/reference/downstream_compare.py``):

* PCA: singular values at 1e-7 of σ₁ (float32 Gram; found 3e-9), the scores'
  span missing under 1e-12 of the top energy, the projection at 2e-6 of the
  largest score (found 3e-7); with ``high_precision=True`` all at 1e-12;
* the exact kNN: distances at 1e-5 of each row's k-th (float32 products;
  found 5e-7), no neighbour outside the reference's k nearest beyond a tie;
* the connectivities, over ``local_connectivity`` ∈ {1, 1.5} and
  ``set_op_mix_ratio`` ∈ {1, 0.5}: the reference's pattern, each value the
  reference's float64 membership rounded to float32, within one ulp;
* ``cnv_score`` from the port's labels at 1e-6 relative (float32 sums);
* Leiden: every community connected, its quality above the planted
  partition's;
* UMAP: shape, finite coordinates, graph neighbours kept in the layout at
  5× chance or more, and its cross-entropy on the graph under the limits
  against the spectral start and against the layout permuted within each
  community, which the start itself and a permuted layout read over.

The JAX package's sigma search counts the point itself: a test here shows
that it equals the reference's with column 0 counted (``ROADMAP.md`` A,
defect 5), and that umap-learn's rule differs from it.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import infercnvpy_tpu_torch as tcnv  # noqa: E402
from cnvbench import data, spec  # noqa: E402
from cnvbench.reference import downstream as ref  # noqa: E402
from cnvbench.reference import downstream_compare as dcmp  # noqa: E402
from infercnvpy_tpu_torch.ops.graph import fuzzy_connectivities  # noqa: E402
from infercnvpy_tpu_torch.ops.knn import exact_knn  # noqa: E402

CPU = "cpu"
N_CELLS, N_GENES, SEED = 2000, 6000, 2**31 + 21


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def chain():
    """``(adata after the whole chain, the chain's outputs, the reference)``."""
    config = _cell_config()
    config["samples"] = {"count": 1, "cells_min": N_CELLS, "cells_max": N_CELLS}
    steps = dcmp.chain_of(config)
    var = data.make_var(N_GENES)
    sample = data.make_sample(config, var, N_CELLS, SEED, 0, CPU)
    adata = data.make_anndata(sample, var)
    tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=sample.reference_cats, device=CPU)
    tcnv.tl.pca(adata, **steps["pca"], device=CPU)
    tcnv.pp.neighbors(adata, **steps["neighbors"], device=CPU)
    tcnv.tl.leiden(adata, **steps["leiden"])
    tcnv.tl.cnv_score(adata, device=CPU)
    tcnv.tl.umap(adata, **steps["umap"], device=CPU)
    return adata, dcmp.output_of(adata), dcmp.Reference(adata.obsm["X_cnv"], sample.labels, CPU, steps)


def _cell_config() -> dict:
    """The configuration of the cell ``atlas_102k.downstream``, as ``BENCHMARK.json`` names its file."""
    bench = json.loads((spec.ROOT.parent / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == "atlas_102k.downstream")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return json.loads((spec.ROOT.parent / entry["file"]).read_text())


def _default(fn, name):
    import inspect

    return inspect.signature(fn).parameters[name].default


def test_cell_configuration_is_the_entry_points_defaults():
    """The cell runs infercnvpy's documented chain with every default: its ``downstream`` group says so."""
    from infercnvpy_tpu_torch.ops.umap_ import umap_layout

    steps = dcmp.chain_of(_cell_config())
    assert steps == dcmp.CHAIN
    assert _default(tcnv.tl.pca, "n_comps") is None and steps["pca"]["n_comps"] == 50  # min(50, min(shape) - 1)
    assert steps["pca"]["zero_center"] is _default(tcnv.tl.pca, "zero_center")
    assert steps["neighbors"]["n_neighbors"] == _default(tcnv.pp.neighbors, "n_neighbors")
    for key in ("resolution", "random_state"):
        assert steps["leiden"][key] == _default(tcnv.tl.leiden, key)
    for key in ("min_dist", "spread"):
        assert steps["umap"][key] == _default(umap_layout, key)


def test_chain_of_takes_the_configuration_over_the_defaults():
    steps = dcmp.chain_of({"downstream": {"neighbors": {"n_neighbors": 30}, "umap": {"min_dist": 0.1}}})
    assert steps["neighbors"] == {"n_neighbors": 30}
    assert steps["umap"] == {"min_dist": 0.1, "spread": 1.0}
    assert steps["pca"] == dcmp.CHAIN["pca"] and steps["leiden"] == dcmp.CHAIN["leiden"]
    assert dcmp.chain_of({}) == dcmp.CHAIN
    with pytest.raises(ValueError, match="zero_center"):
        dcmp.chain_of({"downstream": {"pca": {"zero_center": True}}})
    X = sp.random(40, 30, density=0.3, format="csr", random_state=0)
    r = dcmp.Reference(X, np.zeros(40), CPU, dcmp.chain_of({"downstream": {"pca": {"n_comps": 8},
                                                                       "neighbors": {"n_neighbors": 5},
                                                                       "leiden": {"resolution": 0.5}}}))
    assert (r.n_comps, r.k, r.resolution) == (8, 5, 0.5)
    assert r.ab == ref.ab_params(spread=1.0, min_dist=0.5)


@pytest.mark.parametrize("high_precision", [False, True])
def test_pca_matches_the_reference(chain, high_precision):
    adata, out, reference = chain
    bars = {"pca_sval_err": 1e-7, "pca_energy_gap": 1e-12, "pca_proj_err": 2e-6}
    if high_precision:
        again = tcnv.AnnData(obs=adata.obs[["cell_type"]].copy(), obsm={"X_cnv": adata.obsm["X_cnv"]})
        tcnv.tl.pca(again, device=CPU, high_precision=True)
        out = dcmp.Output(scores=again.obsm["X_cnv_pca"], variance=again.uns["cnv_pca"]["variance"],
                          distances=None, connectivities=None, labels=None, cnv_score=None, layout=None)
        bars = dict.fromkeys(bars, 1e-12)
    assert out.scores.shape == (N_CELLS, 50)
    readings = reference.pca_readings(out)
    assert all(readings[k] <= bars[k] for k in bars), readings


def test_exact_knn_matches_the_reference(chain):
    _, out, reference = chain
    readings = reference.knn_readings(out)
    assert readings["knn_dist_err"] <= 1e-5 and readings["knn_set_miss"] == 0.0, readings
    d, i = exact_knn(out.scores, 15, device=CPU)
    want_d, _ = ref.exact_knn(out.scores, 14, CPU)
    npt.assert_array_equal(i[:, 0], np.arange(N_CELLS))
    npt.assert_allclose(d[:, 1:], want_d.numpy(), rtol=0, atol=1e-5 * float(want_d[:, -1].min()))


@pytest.mark.parametrize("local_connectivity,set_op_mix_ratio", [(1.0, 1.0), (1.5, 1.0), (1.0, 0.5), (1.5, 0.5)])
def test_connectivities_match_the_reference(chain, local_connectivity, set_op_mix_ratio):
    """From the port's kNN, the port's graph is the reference's rounded to float32: same pattern, one ulp."""
    _, out, _ = chain
    d, i = exact_knn(out.scores, 15, device=CPU)
    got = fuzzy_connectivities(d, i, local_connectivity=local_connectivity, set_op_mix_ratio=set_op_mix_ratio,
                               device=CPU)
    d64, i64 = torch.from_numpy(d.astype(np.float64)), torch.from_numpy(i.astype(np.int64))
    rho, sigma = ref.smooth_knn_dist(d64, local_connectivity)
    rows, cols, vals = ref.fuzzy_union(i64, ref.membership(d64, i64, rho, sigma), set_op_mix_ratio)
    want = sp.csr_matrix((vals.numpy(), (rows.numpy(), cols.numpy())), shape=got.shape)
    npt.assert_array_equal(got.indptr, want.indptr)
    npt.assert_array_equal(got.indices, want.indices)
    npt.assert_allclose(got.data, want.data.astype(np.float32), rtol=2.0**-23, atol=0)
    if (local_connectivity, set_op_mix_ratio) == (1.0, 1.0):  # the defaults: pp.neighbors' own graph
        npt.assert_array_equal(got.data, out.connectivities.data)


def test_cnv_score_matches_the_reference(chain):
    _, out, reference = chain
    assert reference.cnv_score_err(out) <= 1e-6


def test_leiden_communities_are_connected_and_beat_the_planted_partition(chain):
    adata, out, reference = chain
    readings = reference.leiden_readings(out)
    assert len(np.unique(out.labels)) >= 8
    assert readings["leiden_disconnected"] == 0
    assert readings["leiden_quality_short"] < 0.0, readings


def test_umap_layout_is_finite_and_keeps_neighbours(chain):
    _, out, reference = chain
    readings = reference.umap_readings(out)
    assert out.layout.shape == (N_CELLS, 2) and readings["umap_nonfinite"] == 0
    assert 1.0 - readings["umap_lost"] >= 5 * 14 / N_CELLS, readings
    for k in ("umap_ce_vs_start", "umap_ce_vs_shuffled"):
        assert readings[k] <= dcmp.LIMITS[k], readings


@pytest.mark.parametrize("fault", ["epochs_skipped", "within_communities", "permuted"])
def test_umap_faults_read_over_the_cross_entropy_limits(chain, fault):
    """The spectral start (the epochs skipped) reads over ``umap_ce_vs_start``; the layout permuted within each
    Leiden community, or whole, over ``umap_ce_vs_shuffled``."""
    from infercnvpy_tpu_torch.ops.umap_ import spectral_init

    _, out, reference = chain
    layout = {"epochs_skipped": lambda: spectral_init(out.connectivities),
              "within_communities": lambda: ref.shuffle_within(out.layout, out.labels, seed=5),
              "permuted": lambda: np.random.default_rng(5).permutation(out.layout)}[fault]()
    readings = reference.layout_ce(out, layout)
    k = "umap_ce_vs_start" if fault == "epochs_skipped" else "umap_ce_vs_shuffled"
    assert readings[k] > dcmp.LIMITS[k], readings


@pytest.mark.parametrize("local_connectivity", [1.0, 1.5])
def test_jax_sigma_counts_the_point_itself(chain, local_connectivity):
    """The JAX package's sigma equals the reference's with column 0 counted and no early stop, at 1e-4
    relative: its rho and its gaps ``d - rho`` are float32 (found: 2.2e-5 at ``local_connectivity`` 1.5,
    where rho is interpolated).  umap-learn's rule, the port's, differs from it by more than 10 %."""
    import jax.numpy as jnp

    from infercnvpy_tpu.ops.graph import _smooth_knn_dist as jax_smooth_knn_dist

    _, out, _ = chain
    d, _ = exact_knn(out.scores, 15, device=CPU)
    j_rho, j_sigma = (np.asarray(a, np.float64) for a in jax_smooth_knn_dist(jnp.asarray(d), local_connectivity))
    d64 = torch.from_numpy(d.astype(np.float64))
    rho, counting_self = ref.smooth_knn_dist(d64, local_connectivity, count_self=True)
    _, umap_learn = ref.smooth_knn_dist(d64, local_connectivity)
    npt.assert_allclose(j_rho, rho.numpy(), rtol=1e-6)
    npt.assert_allclose(j_sigma, counting_self.numpy(), rtol=1e-4)
    assert np.max(np.abs(j_sigma / umap_learn.numpy() - 1.0)) > 0.1


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys, cnvbench.reference.downstream, cnvbench.reference.downstream_compare\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'infercnvpy_tpu', "
            "'infercnvpy_tpu_torch')]\n"
            "assert not bad, bad")
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300)
