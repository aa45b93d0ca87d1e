"""Embedding scatter plots (copied from ``infercnvpy_tpu.pl._embedding``).

Counterpart of scanpy's sc.pl.embedding used at reference
pl/__init__.py:7-20; the figure is closed as in :mod:`._chromosome_heatmap`.
"""

from __future__ import annotations

import numpy as np

from ._chromosome_heatmap import _save_or_show

__all__ = ["embedding", "umap", "tsne"]


def embedding(adata, basis: str, *, color=None, show: bool | None = None, save=None, figsize=(8, 6), **kwargs):
    """Scatter plot of cells in an ``obsm["X_{basis}"]`` embedding, colored by obs columns."""
    import matplotlib.pyplot as plt

    key = f"X_{basis}" if not basis.startswith("X_") else basis
    if key not in adata.obsm:
        raise KeyError(f"{key} not found in adata.obsm.")
    emb = np.asarray(adata.obsm[key])

    colors = [color] if isinstance(color, str) or color is None else list(color)
    fig, axs = plt.subplots(1, len(colors), figsize=(figsize[0] * len(colors), figsize[1]), squeeze=False)
    axes = []
    for ax, col in zip(axs[0], colors):
        if col is None:
            ax.scatter(emb[:, 0], emb[:, 1], s=8, c="tab:blue")
        else:
            values = adata.obs[col]
            if values.dtype.kind in "fiu":
                sc_ = ax.scatter(emb[:, 0], emb[:, 1], s=8, c=np.asarray(values), cmap="viridis")
                fig.colorbar(sc_, ax=ax, shrink=0.7, label=col)
            else:
                cats = list(dict.fromkeys(values))
                cmap_cat = plt.get_cmap("tab20")
                for i, cat in enumerate(cats):
                    m = np.asarray(values) == cat
                    ax.scatter(emb[m, 0], emb[m, 1], s=8, color=cmap_cat(i % 20), label=str(cat))
                ax.legend(markerscale=2, fontsize=8, loc="best")
        ax.set_title(col if col else basis)
        ax.set_xlabel(f"{basis}1")
        ax.set_ylabel(f"{basis}2")
        axes.append(ax)
    shown = _save_or_show(fig, basis, show, save)
    if not shown:
        return axes if len(axes) > 1 else axes[0]
    return None


def umap(adata, **kwargs):
    """Plot the CNV UMAP (reference: pl/__init__.py:7-12)."""
    return embedding(adata, "cnv_umap", **kwargs)


def tsne(adata, **kwargs):
    """Plot the CNV t-SNE (reference: pl/__init__.py:15-20)."""
    return embedding(adata, "cnv_tsne", **kwargs)
