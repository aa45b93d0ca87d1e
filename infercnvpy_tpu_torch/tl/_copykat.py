"""copyKAT bridge (host-only, optional; requires rpy2 + R `copykat`); copied from ``infercnvpy_tpu.tl._copykat``.

The reference embeds an R script via rpy2 (reference: tl/_copykat.py:10-177).
This environment has no R; the bridge keeps the exact API and marshaling
semantics and raises a clear ImportError when rpy2/R are unavailable —
mirroring the reference's lazy-import behavior (:90-96).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["copykat"]


def copykat(
    adata,
    gene_ids: str = "S",
    organism: str = "human",
    segmentation_cut: float = 0.1,
    distance: str = "euclidean",
    s_name: str = "copykat_result",
    min_genes_chr: int = 5,
    key_added: str = "cnv",
    inplace: bool = True,
    layer: str | None = None,
    n_jobs: int | None = None,
    norm_cell_names: str = "",
    cell_line="no",
    window_size: int = 25,
):
    """Inference of genomic copy number from scRNA-seq via the R `copykat` package.

    Parameters mirror the reference (reference: tl/_copykat.py:10-83).
    """
    try:
        from rpy2 import robjects as ro
        from rpy2.robjects import numpy2ri, pandas2ri  # noqa: F401
        from rpy2.robjects.packages import importr
    except ImportError:
        raise ImportError("copykat requires rpy2 (and an R installation with the `copykat` package). ") from None

    try:
        importr("copykat")
        importr("stringr")
    except Exception as e:  # pragma: no cover - needs R
        raise ImportError("The R copykat/stringr packages are required but could not be loaded. ") from e

    import os

    if os.name != "posix":
        n_jobs = 1
    elif n_jobs is None:
        n_jobs = os.cpu_count()

    expr = adata.X if layer is None else adata.layers[layer]
    if sp.issparse(expr):
        expr = expr.toarray()
    expr_df = _to_r_matrix_df(expr, adata)

    with ro.default_converter.context():  # pragma: no cover - needs R
        from rpy2.robjects import conversion

        ro.globalenv["expr_r"] = conversion.get_conversion().py2rpy(expr_df)
        ro.globalenv["n_jobs"] = n_jobs
        ro.globalenv["gene_ids"] = gene_ids
        ro.globalenv["segmentation_cut"] = segmentation_cut
        ro.globalenv["distance"] = distance
        ro.globalenv["s_name"] = s_name
        ro.globalenv["min_genes_chr"] = min_genes_chr
        ro.globalenv["norm_cell_names"] = norm_cell_names
        ro.globalenv["window_size"] = window_size
        ro.globalenv["cell_line"] = cell_line
        genome = "hg20" if organism == "human" else "mm10"
        ro.r(
            f"""
            copykat_result <- copykat::copykat(
                rawmat = as.matrix(expr_r), id.type = gene_ids, ngene.chr = min_genes_chr,
                win.size = {window_size}, KS.cut = segmentation_cut, sam.name = s_name,
                distance = distance, norm.cell.names = norm_cell_names, n.cores = n_jobs,
                cell.line = cell_line, genome = "{genome}", output.seg = FALSE)
            """
        )
        cna = conversion.get_conversion().rpy2py(ro.r("data.frame(copykat_result$CNAmat)"))
        pred = conversion.get_conversion().rpy2py(ro.r("data.frame(copykat_result$prediction)"))

    return _store_copykat(adata, cna, pred, key_added, inplace)  # pragma: no cover - needs R


def _to_r_matrix_df(expr: np.ndarray, adata):
    """Genes × cells DataFrame for R marshaling (R wants the transposed matrix)."""
    import pandas as pd

    return pd.DataFrame(np.asarray(expr).T, index=adata.var_names, columns=adata.obs_names)


def _store_copykat(adata, cna, pred, key_added, inplace):
    """Write copyKAT outputs into the AnnData slots.

    Storage contract matches the reference (reference: tl/_copykat.py:158-177):
    ``uns[key_added]["chr_pos"]`` maps each chromosome to its first row in the
    CNA matrix, ``obsm[f"X_{key_added}"]`` holds the cells × windows matrix
    aligned to ``obs_names``, and the tumor/normal call lands in
    ``adata.obs[key_added]`` (NaN for cells copyKAT dropped).  With
    ``inplace=False`` returns ``(matrix, prediction_series)``.

    ``cna``  — windows × (chrom, chrompos, abspos, one column per kept cell)
    ``pred`` — indexed by cell name (or holding a ``cell.names`` column) with
               a ``copykat.pred`` column
    """
    chr_pos: dict[str, int] = {}
    for i, c in enumerate(cna["chrom"].astype(int).values):
        chr_pos.setdefault(f"chr{c}", i)

    mtx = cna.drop(["chrom", "chrompos", "abspos"], axis=1)
    mtx = mtx.loc[:, adata.obs.index].T.values

    if "cell.names" in pred.columns:
        pred = pred.set_index("cell.names")
    pred_series = adata.obs.merge(pred, left_index=True, right_index=True, how="left")["copykat.pred"]

    if inplace:
        adata.uns[key_added] = {"chr_pos": chr_pos}
        adata.obsm[f"X_{key_added}"] = mtx
        adata.obs[key_added] = pred_series
        return None
    return mtx, pred_series
