"""Tools: CNV inference (the ported slice of ``infercnvpy_tpu.tl``)."""

from ._infercnv import infercnv

__all__ = ["infercnv"]
