"""Multi-process runs on ``torch.distributed`` (counterpart of ``infercnvpy_tpu/parallel/distributed.py``).

Every process holds its own horizontal slice of the cell axis, in rank order
(e.g. its shard of a distributed AnnData store), and packs it locally
(``ops.infercnv_kernel.pack_csr``).  :func:`infercnv_distributed` runs the
per-row front (the fused kernel for f32 on a CUDA device) on this process's
rows, ``all_gather``s the per-row sums and sums² of every rank (padded to the
longest rank, the lengths gathered first), and takes the one-device chunk
threshold on their concatenation on every rank; each rank returns its own
gated rows.  Chunk ids are global cell indices over ``chunksize``, so an
N-process run gives the bits of one process, chunks crossing ranks included.

With NCCL the collectives take CUDA tensors; with gloo the few floats per
cell go through the host, since gloo's CUDA support varies across
collectives.  Nothing here tells a process of its cluster: the caller gives
:func:`initialize` the address, the world size and the rank (or ``torchrun``
sets ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` in the environment).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..genome.plan import WindowPlan
from ..ops.infercnv_kernel import build_infercnv_back, build_infercnv_front

__all__ = ["initialize", "global_cell_mesh", "infercnv_distributed"]


def initialize(backend: str | None = None, init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    Does nothing for a single process or when the group is already
    initialised (``infercnvpy_tpu/parallel/distributed.py:38-51``).
    ``world_size`` / ``rank`` default to the ``WORLD_SIZE`` / ``RANK``
    environment variables, ``init_method`` to ``env://``, ``backend`` to
    ``"nccl"`` where CUDA is available, else ``"gloo"``.
    """
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 or dist.is_initialized():
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def global_cell_mesh() -> list[torch.device]:
    """This process's cell-shard device, as a one-device list.

    ``cuda:{LOCAL_RANK % device_count}`` where CUDA is available (``LOCAL_RANK``
    defaults to the rank), else the CPU (gloo without CUDA).
    """
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return [torch.device("cuda", local % torch.cuda.device_count())]


def _all_gather_rows(t: torch.Tensor, comm_device: torch.device) -> tuple[torch.Tensor, list[int]]:
    """Every rank's ``t`` (rows first) joined in rank order, and each rank's row count."""
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=comm_device)
    sizes = [torch.zeros_like(n) for _ in range(dist.get_world_size())]
    dist.all_gather(sizes, n)
    sizes = [int(s) for s in sizes]
    padded = torch.zeros((max(sizes),) + tuple(t.shape[1:]), dtype=t.dtype, device=comm_device)
    padded[: t.shape[0]] = t.to(comm_device)
    parts = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(parts, padded)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)]), sizes


def infercnv_distributed(
    local_packed,
    ref,
    local_chunk_ids,
    plan: WindowPlan,
    *,
    n_ref_rows: int | None = None,
    lfc_clip: float = 3.0,
    dynamic_threshold: float | None = 1.5,
    num_chunks: int = 1,
    calculate_gene_values: bool = False,
    dtype: torch.dtype = torch.float32,
    device=None,
):
    """This process's gated rows of the infercnv transform over all ranks' cells: ``(x_res, gene_res)``.

    ``local_packed`` (this rank's rows × ``packed_width(plan)``), the packed
    baseline ``ref`` and ``local_chunk_ids`` (the global chunk ids of this
    rank's rows) are numpy arrays or tensors; they go to ``device``
    (``None``: :func:`global_cell_mesh`).  Every rank of an initialised group
    must call this; outside one it is the one-process transform.  Results
    are tensors on the device, ``gene_res`` ``None`` without gene values.
    """
    dev = torch.device(device) if device is not None else global_cell_mesh()[0]
    x = torch.as_tensor(local_packed).to(dev)
    ref = torch.as_tensor(ref).to(dev)
    cid = torch.as_tensor(np.asarray(local_chunk_ids)).to(dev)
    front = build_infercnv_front(
        plan, n_ref_rows=ref.shape[0] if n_ref_rows is None else n_ref_rows, lfc_clip=lfc_clip, dtype=dtype
    )
    threshold, finish = build_infercnv_back(
        plan, dynamic_threshold=dynamic_threshold, num_chunks=num_chunks, calculate_gene_values=calculate_gene_values
    )
    x_res, rs, rsq = front(x, ref)
    if dynamic_threshold is None or not dist.is_initialized():
        return finish(x_res, threshold(rs, rsq, cid))
    comm = dev if dist.get_backend() == "nccl" else torch.device("cpu")
    stats, sizes = _all_gather_rows(torch.stack([rs, rsq], dim=1), comm)
    cids, _ = _all_gather_rows(cid, comm)
    row_thr = threshold(stats[:, 0].contiguous().to(dev), stats[:, 1].contiguous().to(dev), cids.to(dev))
    start = sum(sizes[: dist.get_rank()])
    return finish(x_res, row_thr[start : start + x_res.shape[0]])
