"""Lightweight AnnData-compatible data container + h5ad IO.

The reference framework piggybacks on the ``anndata`` package as its data
substrate (reference: src/infercnvpy/tl/_infercnv.py:10).  This package is
standalone: :class:`AnnData` implements the subset of the anndata API that the
CNV stack relies on (X / layers / obs / var / obsm / varm / obsp / uns / raw,
subsetting, h5ad round-trip compatible with the anndata on-disk spec v0.1.0).
"""

from .anndata import AnnData, Raw
from .h5ad import read_h5ad, write_h5ad

__all__ = ["AnnData", "Raw", "read_h5ad", "write_h5ad"]
