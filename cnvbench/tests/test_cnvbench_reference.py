"""The plain reference against the port's CPU path at small sizes, and its independence from the program."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from cnvbench import data, spec
from cnvbench.reference import compare as cmp
from cnvbench.reference.infercnv import Params, Reference, row_median, window_weights


def _var_with_extras(n_genes: int):
    """The benchmark genome plus genes the gene mask drops (chrX, chrY, no position) and a chrM gene."""
    var = data.make_var(n_genes)
    extra = pd.DataFrame({"chromosome": ["chrX", "chrY", None, "chrM", "chrX"], "start": [5, 9, 3, 7, 1]},
                         index=[f"extra_{i}" for i in range(5)])
    extra["end"] = extra["start"] + 1000
    var = pd.concat([var, extra])
    return var.iloc[np.random.default_rng(0).permutation(len(var))]


@pytest.mark.parametrize("n_genes,window,step", [(1500, 100, 10), (20_000, 100, 10), (3000, 40, 7), (800, 250, 25)])
def test_window_plan_matches_the_port(n_genes, window, step):
    from infercnvpy_tpu_torch.genome.plan import build_window_plan

    var = data.make_var(n_genes)
    w = window_weights(var, window, step)
    plan = build_window_plan(var, window, step)
    assert w.weights.shape == (n_genes, plan.n_windows)
    assert w.chr_pos == plan.chr_pos
    np.testing.assert_allclose(w.weights.sum(axis=0), 1.0, rtol=1e-12)


def test_row_median_is_numpys():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(7, 10)))
    for cols in (9, 10):
        np.testing.assert_array_equal(row_median(x[:, :cols]).numpy(), np.median(x[:, :cols].numpy(), axis=1))


def _run_port(sample, var, ref_cats, **kw):
    import infercnvpy_tpu_torch as tcnv

    adata = data.make_anndata(sample, var)
    tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=ref_cats, device="cpu", **kw)
    return adata.obsm["X_cnv"], adata.uns["cnv"]["chr_pos"]


@pytest.mark.parametrize("case", ["two_refs_chunks", "one_ref", "no_gate", "masked_genes"])
def test_reference_matches_the_port_on_the_cpu(case):
    config = json.loads((spec.ROOT / "configs" / "atlas_102k.json").read_text())
    var = _var_with_extras(1500) if case == "masked_genes" else data.make_var(1500)
    sample = data.make_sample(config, var, 1200, 77, 0, "cpu")
    cats = sample.reference_cats[:1] if case == "one_ref" else sample.reference_cats
    params = Params(chunksize=500, dynamic_threshold=None if case == "no_gate" else 1.5)
    x_cnv, chr_pos = _run_port(sample, var, cats, chunksize=500, dynamic_threshold=params.dynamic_threshold)
    ref = Reference(sample.X, var, sample.labels, cats, params, "cpu")
    r = cmp.compare(x_cnv, chr_pos, ref)
    assert r.layout_mismatch == 0
    assert r.value_err < 1e-6  # f32 program against the f64 reference
    assert r.gate_flip_share < 1e-4
    assert r.ok()


def test_compare_catches_a_shifted_value_and_a_wrong_layout():
    config = json.loads((spec.ROOT / "configs" / "atlas_102k.json").read_text())
    var = data.make_var(1500)
    sample = data.make_sample(config, var, 600, 5, 0, "cpu")
    x_cnv, chr_pos = _run_port(sample, var, sample.reference_cats)
    ref = Reference(sample.X, var, sample.labels, sample.reference_cats, Params(), "cpu")
    bad = x_cnv.copy()
    bad.data[len(bad.data) // 2] += 0.01
    assert cmp.compare(bad, chr_pos, ref).value_err >= 0.009
    dropped = x_cnv.copy()
    dropped.data[: len(dropped.data) // 100] = 0
    dropped.eliminate_zeros()
    assert not cmp.compare(dropped, chr_pos, ref).ok()
    moved = dict(chr_pos, chr2=chr_pos["chr2"] + 1)
    assert cmp.compare(x_cnv, moved, ref).layout_mismatch == 1
    assert cmp.digest(x_cnv, chr_pos) != cmp.digest(bad, chr_pos)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, json; import cnvbench.reference.infercnv, cnvbench.reference.compare; "
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('infercnvpy_tpu_torch', 'infercnvpy_tpu', 'jax'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT.parent, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
