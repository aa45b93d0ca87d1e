"""Tools: CNV inference (the ported slice of ``infercnvpy_tpu.tl``)."""

from ._infercnv import clear_transform_caches, infercnv

__all__ = ["infercnv", "clear_transform_caches"]
