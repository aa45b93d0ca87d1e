"""infercnvpy_tpu_torch — the PyTorch / CUDA port of ``infercnvpy_tpu``.

Copy-number-variation inference from scRNA-seq on an NVIDIA GPU (Hopper,
``sm_90a``), with a plain PyTorch path for the CPU.  The JAX package
``infercnvpy_tpu`` is the reference this port is tested against; this package
never imports it or JAX.

Ported so far: ``tl.infercnv`` (without per-gene values) and the data layer.
"""

from . import datasets, tl
from .core import AnnData, read_h5ad, write_h5ad

__all__ = ["datasets", "tl", "AnnData", "read_h5ad", "write_h5ad"]
__version__ = "0.1.0"
