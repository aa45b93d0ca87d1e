"""Ingest / annotation: genomic gene positions and external tool results (counterpart of ``infercnvpy_tpu.io``)."""

from ._genepos import genomic_position_from_biomart, genomic_position_from_gtf
from ._scevan import read_scevan

__all__ = ["genomic_position_from_gtf", "genomic_position_from_biomart", "read_scevan"]
