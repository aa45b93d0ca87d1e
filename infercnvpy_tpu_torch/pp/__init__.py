"""Preprocessing: the neighbourhood graph on the CNV representation (counterpart of ``infercnvpy_tpu.pp``).

API mirrors reference pp/__init__.py:8-43; the graph is the port's exact kNN
(tiled products on the device) and fuzzy connectivities instead of
scanpy/pynndescent.
"""

from __future__ import annotations

import scipy.sparse as sp

from .. import tl
from .._util import pick_shards, warn

__all__ = ["neighbors"]


def neighbors(
    adata,
    use_rep: str = "cnv_pca",
    key_added: str = "cnv_neighbors",
    inplace: bool = True,
    n_neighbors: int = 15,
    random_state: int = 0,
    *,
    device=None,
    **kwargs,
):
    """Compute the neighbourhood graph based on the result of :func:`tl.infercnv`.

    Auto-runs :func:`tl.pca` when ``X_cnv_pca`` is missing, matching the
    reference (pp/__init__.py:39-41).  Stores ``obsp["{key_added}_distances"]``
    (exact kNN distances) and ``obsp["{key_added}_connectivities"]`` (fuzzy
    union weights), plus a scanpy-compatible ``uns[key_added]`` block.
    ``device=None`` is the CUDA device; a list of devices splits the kNN
    query blocks over them (the connectivities run on the first).
    """
    from ..ops.graph import fuzzy_connectivities, knn_distance_matrix
    from ..ops.knn import exact_knn

    devices = pick_shards(device, "pp.neighbors")
    if f"X_{use_rep}" not in adata.obsm and use_rep == "cnv_pca":
        warn("X_cnv_pca not found in adata.obsm. Computing PCA with default parameters")
        tl.pca(adata, device=devices)

    X = adata.obsm[f"X_{use_rep}"]
    if sp.issparse(X):
        X = X.toarray()
    k = int(min(n_neighbors, X.shape[0]))
    dists, idxs = exact_knn(X, k, device=devices, **kwargs)
    distances = knn_distance_matrix(dists, idxs)
    connectivities = fuzzy_connectivities(dists, idxs, device=devices[0])

    if not inplace:
        return distances, connectivities

    adata.obsp[f"{key_added}_distances"] = distances
    adata.obsp[f"{key_added}_connectivities"] = connectivities
    adata.uns[key_added] = {
        "connectivities_key": f"{key_added}_connectivities",
        "distances_key": f"{key_added}_distances",
        "params": {
            "n_neighbors": k,
            "method": "umap",
            "metric": "euclidean",
            "use_rep": f"X_{use_rep}",
            "random_state": random_state,
        },
    }
    return None
