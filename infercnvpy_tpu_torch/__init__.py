"""infercnvpy_tpu_torch — the PyTorch / CUDA port of ``infercnvpy_tpu``.

Copy-number-variation inference from scRNA-seq on an NVIDIA GPU (Hopper,
``sm_90a``), with a plain PyTorch path for the CPU.  The JAX package
``infercnvpy_tpu`` is the reference this port is tested against; this package
never imports it or JAX.

Ported so far: single-device ``tl.infercnv`` with every option (per-gene
values, checkpoint/resume, reduced-precision transfer, the pipelined copy
stream); the downstream workflow on one device (``tl.pca``,
``pp.neighbors``, ``tl.leiden``, ``tl.cnv_score`` / ``ithcna`` / ``ithgex``,
``tl.umap``, ``tl.tsne``); ``io`` (gene positions from a GTF file or
Biomart, the SCEVAN and RData readers); ``pl`` (chromosome heatmaps,
embedding plots) and the ``settings`` they read; the ``tl.copykat`` bridge;
``datasets`` with ``maynard2020_3k``; ``profiling``; the data layer; and the
write-bandwidth probe (``python -m infercnvpy_tpu_torch.ops.probe``).  Only
runs on several devices are still missing.
"""

from . import datasets, io, pl, pp, profiling, settings, tl
from .core import AnnData, read_h5ad, write_h5ad

__all__ = ["datasets", "io", "pl", "pp", "profiling", "settings", "tl", "AnnData", "read_h5ad", "write_h5ad"]
__version__ = "0.1.0"
