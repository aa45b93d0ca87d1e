"""Chromosome heatmap figures (copied from ``infercnvpy_tpu.pl._chromosome_heatmap``).

Behavioral counterpart of reference pl/_chromosome_heatmap.py, with one
repair: every figure is closed once it is shown or saved, so pyplot holds no
figure per call; the axes a call returns keep their figure alive.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .. import settings

__all__ = ["chromosome_heatmap", "chromosome_heatmap_summary"]


def _save_or_show(fig, name: str, show: bool | None, save):
    import matplotlib.pyplot as plt

    if save:
        settings.figdir.mkdir(parents=True, exist_ok=True)
        suffix = save if isinstance(save, str) else ".png"
        fname = f"{name}{suffix}"
        fig.savefig(settings.figdir / fname, dpi=150, bbox_inches="tight")
    show = settings.autoshow if show is None else show
    if show:
        plt.show()
    # pyplot would keep the figure for the life of the process otherwise
    plt.close(fig)
    return show


def _sorted_chr_pos(uns_entry: dict) -> dict:
    # re-sort, as saving & loading h5ad may destroy dict order
    # (reference: pl/_chromosome_heatmap.py:57-59)
    return dict(sorted(uns_entry["chr_pos"].items(), key=lambda x: x[1]))


def _group_order(adata, groupby: str):
    values = adata.obs[groupby]
    if hasattr(values, "cat"):
        cats = list(values.cat.categories)
    else:
        cats = list(dict.fromkeys(values))
    order = np.argsort([cats.index(v) for v in values], kind="stable")
    return order, cats, np.asarray(values)[order]


def _dendrogram_group_order(X, groups, group_values) -> list:
    """Group order from hierarchical clustering of per-group mean profiles
    (the behavior of the reference's ``dendrogram=True`` pass-through to
    ``sc.pl.heatmap``, reference: pl/_chromosome_heatmap.py:74-85)."""
    from scipy.cluster.hierarchy import leaves_list, linkage

    means = []
    for g in groups:
        mask = np.asarray(group_values == g)
        sub = X[mask, :]
        means.append(np.asarray(sub.mean(axis=0)).ravel())
    if len(means) < 3:
        return list(groups)
    order = leaves_list(linkage(np.vstack(means), method="complete", metric="euclidean"))
    return [groups[i] for i in order]


def _draw_heatmap(X, row_groups, group_names, chr_pos_dict, n_windows, cmap, figsize, vmin, vmax, **imshow_kwargs):
    import matplotlib.pyplot as plt
    from matplotlib.colors import TwoSlopeNorm

    if vmin is None:
        vmin = float(np.nanmin(X))
    if vmax is None:
        vmax = float(np.nanmax(X))
    if vmin >= 0:
        vmin = -1e-6
    if vmax <= 0:
        vmax = 1e-6
    norm = TwoSlopeNorm(0, vmin=vmin, vmax=vmax)

    fig = plt.figure(figsize=figsize)
    gs = fig.add_gridspec(1, 2, width_ratios=[1, 40], wspace=0.02)
    gax = fig.add_subplot(gs[0, 0])
    ax = fig.add_subplot(gs[0, 1])

    imshow_kwargs.setdefault("interpolation", "nearest")
    ax.imshow(X, aspect="auto", cmap=cmap, norm=norm, **imshow_kwargs)

    chr_pos = list(chr_pos_dict.values())
    ax.vlines(np.asarray(chr_pos[1:]) - 0.5, lw=0.6, ymin=-0.5, ymax=X.shape[0] - 0.5, color="black")
    spans = list(zip(chr_pos, chr_pos[1:] + [n_windows]))
    ax.set_xticks([(a + b) / 2 for a, b in spans])
    ax.set_xticklabels(list(chr_pos_dict.keys()), rotation=90, fontsize=8)
    ax.set_yticks([])

    # group color band
    uniq = list(dict.fromkeys(group_names))
    cmap_cat = plt.get_cmap("tab20")
    colors = {g: cmap_cat(i % 20) for i, g in enumerate(uniq)}
    band = np.asarray([colors[g] for g in row_groups])
    gax.imshow(band[:, None, :], aspect="auto", interpolation="nearest")
    gax.set_xticks([])
    gax.set_yticks([])
    # group boundary labels
    boundaries = np.flatnonzero(np.asarray(row_groups[:-1]) != np.asarray(row_groups[1:])) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(row_groups)]])
    for s, e in zip(starts, ends):
        gax.text(-0.7, (s + e) / 2, str(row_groups[s]), ha="right", va="center", fontsize=8)
        ax.hlines(s - 0.5, xmin=-0.5, xmax=X.shape[1] - 0.5, lw=0.4, color="black")

    fig.colorbar(ax.images[0], ax=ax, shrink=0.5, label="CNV")
    return fig, {"heatmap_ax": ax, "groupby_ax": gax}


def chromosome_heatmap(
    adata,
    *,
    groupby: str = "cnv_leiden",
    use_rep: str = "cnv",
    cmap="bwr",
    figsize: tuple[int, int] = (16, 10),
    show: bool | None = None,
    save=None,
    vmin=None,
    vmax=None,
    dendrogram: bool = False,
    **kwargs,
):
    """Heatmap of smoothed gene expression by chromosome, cells grouped by ``groupby``.

    Reference behavior: pl/_chromosome_heatmap.py:11-92 (TwoSlopeNorm centered
    at 0, chromosome span labels, boundary vlines, cnv_leiden guard).
    ``dendrogram=True`` orders the groups by hierarchical clustering of their
    mean CNV profiles; remaining ``**kwargs`` go to ``Axes.imshow``.
    """
    if groupby == "cnv_leiden" and "cnv_leiden" not in adata.obs.columns:
        raise ValueError("'cnv_leiden' is not in `adata.obs`. Did you run `tl.leiden()`?")
    X = adata.obsm[f"X_{use_rep}"]
    if sp.issparse(X):
        X = X.toarray()
    X = np.asarray(X)

    order, cats, row_groups = _group_order(adata, groupby)
    if dendrogram:
        values = np.asarray(adata.obs[groupby])
        cats = _dendrogram_group_order(X, [c for c in cats if (values == c).any()], values)
        rank = {g: i for i, g in enumerate(cats)}
        order = np.argsort([rank.get(v, len(rank)) for v in values], kind="stable")
        row_groups = values[order]
    chr_pos_dict = _sorted_chr_pos(adata.uns[use_rep])

    fig, axes = _draw_heatmap(
        X[order], row_groups, row_groups, chr_pos_dict, X.shape[1], cmap, figsize, vmin, vmax, **kwargs
    )
    shown = _save_or_show(fig, "heatmap", show, save)
    if not shown:
        return axes
    return None


def chromosome_heatmap_summary(
    adata,
    *,
    groupby: str = "cnv_leiden",
    use_rep: str = "cnv",
    cmap="bwr",
    figsize: tuple[int, int] = (16, 10),
    show: bool | None = None,
    save=None,
    vmin=None,
    vmax=None,
    dendrogram: bool = False,
    **kwargs,
):
    """Heatmap of the per-group average CNV profile (reference: :95-193).

    ``dendrogram=True`` orders the groups by hierarchical clustering of their
    mean CNV profiles; remaining ``**kwargs`` go to ``Axes.imshow``.
    """
    if groupby == "cnv_leiden" and "cnv_leiden" not in adata.obs.columns:
        raise ValueError("'cnv_leiden' is not in `adata.obs`. Did you run `tl.leiden()`?")
    X = adata.obsm[f"X_{use_rep}"]
    groups = list(dict.fromkeys(adata.obs[groupby]))
    if dendrogram:
        groups = _dendrogram_group_order(X, groups, np.asarray(adata.obs[groupby]))
    rows = []
    for g in groups:
        mask = np.asarray(adata.obs[groupby].values == g)
        sub = X[mask, :]
        mean = np.asarray(sub.mean(axis=0)).ravel()
        rows.append(mean)
    M = np.vstack(rows)

    chr_pos_dict = _sorted_chr_pos(adata.uns[use_rep])
    fig, axes = _draw_heatmap(M, np.asarray(groups), groups, chr_pos_dict, M.shape[1], cmap, figsize, vmin, vmax, **kwargs)
    shown = _save_or_show(fig, "heatmap", show, save)
    if not shown:
        return axes
    return None
