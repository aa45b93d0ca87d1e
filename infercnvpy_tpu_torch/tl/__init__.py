"""Tools: CNV inference and the downstream analysis of the CNV matrix (counterpart of ``infercnvpy_tpu.tl``).

API surface mirrors the reference's ``tl`` namespace (reference:
tl/__init__.py) without its scanpy / leidenalg / umap-learn / sklearn
dependencies.  Entry points with a ``device`` argument run on the CUDA device
when it is ``None`` and raise where there is none; ``infercnv`` takes every
visible GPU then.  ``infercnv``, ``pca``, ``cnv_score``, ``ithcna`` and
``ithgex`` also take a list of devices and split the cells over them (the
JAX package's ``mesh``).  ``leiden``, ``cnv_score`` without a ``device`` and
the ``copykat`` bridge to R run on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from .. import profiling
from .._util import pick_device, pick_shards, warn
from ._copykat import copykat
from ._infercnv import clear_transform_caches, infercnv
from ._scores import cnv_score, ithcna, ithgex

__all__ = [
    "infercnv", "copykat", "cnv_score", "ithcna", "ithgex", "pca", "umap", "tsne", "leiden", "clear_transform_caches",
]


def leiden(
    adata,
    neighbors_key: str = "cnv_neighbors",
    key_added: str = "cnv_leiden",
    inplace: bool = True,
    resolution: float = 1.0,
    random_state: int = 0,
    **kwargs,
):
    """Leiden clustering on the CNV neighbourhood graph; host only (the native library).

    Counterpart of the reference's thin scanpy wrapper (reference:
    tl/__init__.py:13-30) on ``obsp["{neighbors_key}_connectivities"]``.
    """
    from ..ops.leiden import leiden as _leiden

    conn_key = f"{neighbors_key}_connectivities"
    if conn_key not in adata.obsp:
        raise KeyError(f"{conn_key} not found in adata.obsp. Did you run `pp.neighbors`?")
    if not inplace:
        adata = adata.copy()
    with profiling.span("leiden", cells=adata.n_obs):
        labels = _leiden(adata.obsp[conn_key], resolution=resolution, seed=random_state, **kwargs)
        adata.obs[key_added] = pd.Categorical([str(x) for x in labels],
                                              categories=[str(x) for x in sorted(set(labels))])
    adata.uns[key_added] = {"params": {"resolution": resolution, "random_state": random_state}}
    return None if inplace else adata


def pca(
    adata,
    svd_solver: str = "arpack",
    zero_center: bool = False,
    inplace: bool = True,
    use_rep: str = "cnv",
    key_added: str = "cnv_pca",
    n_comps: int | None = None,
    *,
    device=None,
    **kwargs,
) -> np.ndarray | None:
    """PCA on the result of :func:`infercnv` (reference: tl/__init__.py:33-75).

    ``svd_solver`` is accepted for API compatibility; the port always uses
    the blocked-Gram eigendecomposition (:func:`infercnvpy_tpu_torch.ops.linalg.truncated_svd`).
    ``device=None`` is the CUDA device; a list of devices splits the cells
    over them.
    """
    from ..ops.linalg import truncated_svd

    devices = pick_shards(device, "tl.pca")
    if f"X_{use_rep}" not in adata.obsm:
        raise KeyError(f"X_{use_rep} is not in adata.obsm. Did you run `tl.infercnv`?")
    X = adata.obsm[f"X_{use_rep}"]
    if n_comps is None:
        n_comps = min(50, min(X.shape) - 1)
    with profiling.span("pca", cells=X.shape[0], comps=n_comps):
        scores, components, svals = truncated_svd(X, n_comps, zero_center=zero_center, device=devices, **kwargs)
    if inplace:
        adata.obsm[f"X_{key_added}"] = scores
        adata.uns[key_added] = {"variance": (svals**2) / max(1, X.shape[0] - 1)}
        return None
    return scores


def umap(
    adata,
    neighbors_key: str = "cnv_neighbors",
    key_added: str = "cnv_umap",
    inplace: bool = True,
    *,
    device=None,
    **kwargs,
):
    """UMAP of the CNV neighbourhood graph (reference: tl/__init__.py:78-108); ``device=None`` is the CUDA device."""
    from ..ops.umap_ import umap_layout

    dev = pick_device(device, "tl.umap")
    conn_key = f"{neighbors_key}_connectivities"
    if conn_key not in adata.obsp:
        raise KeyError(f"{conn_key} not found in adata.obsp. Did you run `pp.neighbors`?")
    with profiling.span("umap", cells=adata.n_obs):
        emb = umap_layout(adata.obsp[conn_key], device=dev, **kwargs)
    if inplace:
        adata.obsm[f"X_{key_added}"] = emb
        return None
    return emb


def tsne(
    adata,
    use_rep: str = "cnv_pca",
    key_added: str = "cnv_tsne",
    inplace: bool = True,
    *,
    device=None,
    **kwargs,
):
    """t-SNE of the CNV PCA (reference: tl/__init__.py:111-144); ``device=None`` is the CUDA device.

    Auto-runs :func:`pca` with default parameters if ``X_cnv_pca`` is missing,
    matching the reference (:136-138).
    """
    from ..ops.tsne_ import tsne_embed

    dev = pick_device(device, "tl.tsne")
    if f"X_{use_rep}" not in adata.obsm and use_rep == "cnv_pca":
        warn("X_cnv_pca not found in adata.obsm. Computing PCA with default parameters")
        pca(adata, device=dev)
    emb = tsne_embed(adata.obsm[f"X_{use_rep}"], device=dev, **kwargs)
    if inplace:
        adata.obsm[f"X_{key_added}"] = emb
        return None
    return emb
