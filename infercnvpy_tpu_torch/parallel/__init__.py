"""Runs on several devices and processes: cell shards over a device list, and process groups.

Counterpart of ``infercnvpy_tpu.parallel``: :func:`cell_mesh` is the ordered
device list of a sharded run (one entry per cell shard),
:func:`sharded_infercnv_fn` the transform over its shards, and
:mod:`.distributed` the same over the processes of a ``torch.distributed``
group.
"""

from . import distributed
from .mesh import cell_mesh, mesh_key, pad_rows, replicate, shard_rows
from .sharded import run_sharded_infercnv, sharded_infercnv_fn

__all__ = [
    "cell_mesh", "distributed", "mesh_key", "pad_rows", "replicate", "run_sharded_infercnv", "shard_rows",
    "sharded_infercnv_fn",
]
