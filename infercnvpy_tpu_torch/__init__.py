"""infercnvpy_tpu_torch — the PyTorch / CUDA port of ``infercnvpy_tpu``.

Copy-number-variation inference from scRNA-seq on an NVIDIA GPU (Hopper,
``sm_90a``), with a plain PyTorch path for the CPU.  The JAX package
``infercnvpy_tpu`` is the reference this port is tested against; this package
never imports it or JAX.

Ported so far: single-device ``tl.infercnv`` with every option (per-gene
values, checkpoint/resume, reduced-precision transfer, the pipelined copy
stream), ``profiling``, the data layer, and the write-bandwidth probe
(``python -m infercnvpy_tpu_torch.ops.probe``).
"""

from . import datasets, profiling, tl
from .core import AnnData, read_h5ad, write_h5ad

__all__ = ["datasets", "profiling", "tl", "AnnData", "read_h5ad", "write_h5ad"]
__version__ = "0.1.0"
