"""Two processes of a ``torch.distributed`` gloo group against one process (``parallel.distributed``).

The test runs this file as the child of each rank:

    python tests/test_torch_distributed.py <rank> <world_size> <init_file> <out_dir> <dtype> <device>

Each child joins the group through ``parallel.distributed.initialize`` with a
``file://`` rendezvous in the test's ``tmp_path``, packs its own rows of one
seeded problem (the layout of ``tests/_distributed_child.py``: chunks of 24
cells cross the ranks, whose row counts differ), runs
``infercnv_distributed`` and writes its gated rows.  The test joins them in
rank order and holds them against one process's transform bit for bit.
The children import neither JAX nor the JAX package; the case marked
``cuda`` runs both ranks on one card:

    python -m pytest tests/test_torch_distributed.py -m cuda --noconftest -p no:cacheprovider
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd

ROOT = Path(__file__).resolve().parent.parent
N_CELLS, N_GENES, CHUNK = 64, 200, 24
#: rows of rank 0 (rank 1 takes the rest): 29 / 35, so the gather pads rank 0's rows
SPLIT = 29
CHILD_TIMEOUT = 120


def _problem(dtype):
    """The seeded problem every process builds alike: packed rows, packed baseline, global chunk ids, plan."""
    import scipy.sparse as sp

    from infercnvpy_tpu_torch.genome import build_window_plan
    from infercnvpy_tpu_torch.ops.infercnv_kernel import _pack_lut, pack_columns, pack_csr

    var = pd.DataFrame({
        "chromosome": ["chr1"] * 120 + ["chr2"] * 60 + ["chr3"] * 20,
        "start": list(range(120)) + list(range(60)) + list(range(20)),
    })
    var["end"] = var["start"] + 1
    plan = build_window_plan(var, 15, 4)
    lut = _pack_lut(plan, N_GENES)
    x = sp.random(N_CELLS, N_GENES, density=0.3, format="csr", dtype=np.float64, random_state=1)
    ref = np.random.default_rng(0).normal(size=(2, N_GENES))
    packed = pack_csr(x, plan, lut, dtype=dtype)
    chunk_ids = (np.arange(N_CELLS) // CHUNK).astype(np.int64)
    return packed, pack_columns(ref, plan, lut, dtype=dtype), chunk_ids, plan


KW = dict(lfc_clip=3.0, dynamic_threshold=1.5, num_chunks=-(-N_CELLS // CHUNK), calculate_gene_values=True)


def _child(rank: int, world: int, init_file: str, out_dir: str, dtype: str, device: str) -> None:
    import torch

    from infercnvpy_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.initialize(backend="gloo", init_method=f"file://{init_file}", world_size=world, rank=rank)
    packed, ref, chunk_ids, plan = _problem(np.dtype(dtype))
    rows = (0, SPLIT) if rank == 0 else (SPLIT, N_CELLS)
    x_res, gene_res = distributed.infercnv_distributed(
        packed[rows[0] : rows[1]], ref, chunk_ids[rows[0] : rows[1]], plan,
        dtype=getattr(torch, dtype), device=device, **KW,
    )
    np.savez(Path(out_dir) / f"rank{rank}.npz", x=x_res.cpu().numpy(), gene=gene_res.cpu().numpy())
    torch.distributed.destroy_process_group()


def _one_process(dtype: str, device: str):
    import torch

    from infercnvpy_tpu_torch.ops.infercnv_kernel import build_infercnv_fn

    packed, ref, chunk_ids, plan = _problem(np.dtype(dtype))
    fn = build_infercnv_fn(plan, n_ref_rows=2, dtype=getattr(torch, dtype), **KW)
    x_res, gene_res = fn(torch.from_numpy(packed).to(device), torch.from_numpy(ref).to(device),
                         torch.from_numpy(chunk_ids).to(device))
    return x_res.cpu().numpy(), gene_res.cpu().numpy()


def _run_ranks(tmp_path: Path, dtype: str, device: str):
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    init_file = tmp_path / "rendezvous"
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(rank), "2", str(init_file), str(tmp_path), dtype, device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed (rc={p.returncode}):\n{out}"
    parts = [np.load(tmp_path / f"rank{rank}.npz") for rank in range(2)]
    assert [len(z["x"]) for z in parts] == [SPLIT, N_CELLS - SPLIT]
    return np.concatenate([z["x"] for z in parts]), np.concatenate([z["gene"] for z in parts])


def _assert_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _child(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7])
else:
    import pytest

    torch = pytest.importorskip("torch")

    @pytest.fixture(scope="module", autouse=True)
    def _one_torch_thread():
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(prev)

    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    def test_two_gloo_processes_equal_one_process(tmp_path, dtype):
        got_x, got_g = _run_ranks(tmp_path, dtype, "cpu")
        want_x, want_g = _one_process(dtype, "cpu")
        _assert_bits(got_x, want_x)
        _assert_bits(got_g, want_g)
        assert (got_x == 0).any() and (got_x != 0).any()

    def test_outside_a_group_is_the_one_process_transform():
        import torch.distributed as dist

        from infercnvpy_tpu_torch.parallel import distributed

        distributed.initialize(world_size=1)  # one process: nothing to join
        assert not dist.is_initialized()
        if not torch.cuda.is_available():
            assert distributed.global_cell_mesh() == [torch.device("cpu")]
        packed, ref, chunk_ids, plan = _problem(np.dtype("float32"))
        x_res, gene_res = distributed.infercnv_distributed(packed, ref, chunk_ids, plan, device="cpu", **KW)
        want_x, want_g = _one_process("float32", "cpu")
        _assert_bits(x_res.numpy(), want_x)
        _assert_bits(gene_res.numpy(), want_g)

    @pytest.mark.cuda
    def test_cuda_two_gloo_processes_on_one_card(tmp_path):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
        got_x, got_g = _run_ranks(tmp_path, "float32", "cuda:0")
        want_x, want_g = _one_process("float32", "cuda:0")
        _assert_bits(got_x, want_x)
        _assert_bits(got_g, want_g)
