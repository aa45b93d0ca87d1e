"""infercnvpy_tpu_torch — the PyTorch / CUDA port of ``infercnvpy_tpu``.

Copy-number-variation inference from scRNA-seq on an NVIDIA GPU (Hopper,
``sm_90a``), with a plain PyTorch path for the CPU.  The JAX package
``infercnvpy_tpu`` is the reference this port is tested against; this package
never imports it or JAX.

Every module of the JAX package is ported: ``tl.infercnv`` with every option
(per-gene values, checkpoint/resume, reduced-precision transfer, the
pipelined copy stream), on one device or several (every visible GPU by
default, cell shards over any device list, the processes of a
``torch.distributed`` group: ``parallel``); the downstream workflow
(``tl.pca``, ``pp.neighbors``, ``tl.leiden``, ``tl.cnv_score`` / ``ithcna`` /
``ithgex``, ``tl.umap``, ``tl.tsne``), the first five also over a device list;
``io`` (gene positions from a GTF file or Biomart, the SCEVAN and RData
readers); ``pl`` (chromosome heatmaps, embedding plots) and the ``settings``
they read; the ``tl.copykat`` bridge; ``datasets`` with ``maynard2020_3k``;
``profiling``; the data layer; and the write-bandwidth probe
(``python -m infercnvpy_tpu_torch.ops.probe``).
"""

from . import datasets, io, parallel, pl, pp, profiling, settings, tl
from .core import AnnData, read_h5ad, write_h5ad

__all__ = [
    "datasets", "io", "parallel", "pl", "pp", "profiling", "settings", "tl", "AnnData", "read_h5ad", "write_h5ad",
]
__version__ = "0.1.0"
