"""A whole run on the CPU with the timed path broken underneath: ``correct`` has to come out false.

One case for each fault a ``tl.infercnv`` cell can have: a step that returns
its input unchanged (the noise gate), half of the batch left out and the
mean taken over the rest (the reference means), the exchange between shards
left out (each shard gates on its own rows), and an answer altered where it
is produced.  The sound runs beside them, on one and on two shards, are
correct.
"""

from __future__ import annotations

import pytest

from cnvbench import run, spec
from cnvbench.tests.conftest import write_tiny


@pytest.fixture(autouse=True)
def _fresh_caches():
    import infercnvpy_tpu_torch as tcnv

    tcnv.tl.clear_transform_caches()
    yield
    tcnv.tl.clear_transform_caches()


def _run(tmp_path, shards: int = 1):
    traffic = {"device": ["cuda"] * shards} if shards > 1 else {}
    base = write_tiny(tmp_path, traffic=traffic)
    code, result = run.run_cell(tmp_path, "tiny.small", 2**31 + 3, 0.3, 0, device="cpu", bases=(base, spec.ROOT))
    assert code == 0
    return result


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sound_run_is_correct(tmp_path, shards):
    result = _run(tmp_path, shards)
    assert result["correct"] is True, result["compared"]


def test_gate_returning_its_input(tmp_path, monkeypatch):
    from infercnvpy_tpu_torch.ops import infercnv_kernel

    monkeypatch.setattr(infercnv_kernel, "apply_gate", lambda x, row_thr: x)
    result = _run(tmp_path)
    assert result["correct"] is False
    assert result["compared"]["gate_flip_share"]["value"] > result["compared"]["gate_flip_share"]["limit"]


def test_reference_mean_over_half_the_cells(tmp_path, monkeypatch):
    from infercnvpy_tpu_torch.tl import _infercnv

    mean0 = _infercnv._mean0
    monkeypatch.setattr(_infercnv, "_mean0", lambda X: mean0(X[: X.shape[0] // 2]))
    result = _run(tmp_path)
    assert result["correct"] is False
    assert result["compared"]["value_err"]["value"] > result["compared"]["value_err"]["limit"]


def test_shards_gating_without_the_exchange(tmp_path, monkeypatch):
    from infercnvpy_tpu_torch.tl import _infercnv

    one_device = _infercnv.sharded_infercnv_fn

    def no_exchange(plan, devices, **kw):
        fns = [one_device(plan, [d], **kw) for d in devices]

        def fn(xs, refs, chunk_ids):
            outs = [f([x], [r], [c]) for f, x, r, c in zip(fns, xs, refs, chunk_ids)]
            return [x[0] for x, _ in outs], None

        return fn

    monkeypatch.setattr(_infercnv, "sharded_infercnv_fn", no_exchange)
    result = _run(tmp_path, shards=2)
    assert result["correct"] is False


def test_answer_altered_where_it_is_produced(tmp_path, monkeypatch):
    from infercnvpy_tpu_torch.tl import _infercnv

    compute = _infercnv._infercnv_compute

    def altered(*args, **kw):
        chr_pos, res, per_gene = compute(*args, **kw)
        res = res.copy()
        res.data[len(res.data) // 3] += 0.05
        return chr_pos, res, per_gene

    monkeypatch.setattr(_infercnv, "_infercnv_compute", altered)
    result = _run(tmp_path)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"]
