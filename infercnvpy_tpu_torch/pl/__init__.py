"""Plotting: chromosome heatmaps and embedding scatter plots (counterpart of ``infercnvpy_tpu.pl``).

The reference wraps ``scanpy.pl`` (reference: pl/_chromosome_heatmap.py,
pl/__init__.py); this standalone implementation draws the same figures with
matplotlib directly: row-grouped CNV heatmap with a diverging colormap
centered at 0, chromosome span labels, and boundary lines.
"""

from ._chromosome_heatmap import chromosome_heatmap, chromosome_heatmap_summary
from ._embedding import embedding, tsne, umap

__all__ = ["chromosome_heatmap", "chromosome_heatmap_summary", "umap", "tsne", "embedding"]
