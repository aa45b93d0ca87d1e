"""Read in result files from SCEVAN (copied from ``infercnvpy_tpu.io._scevan``).

Behavioral contract: reference io/_scevan.py.  Uses the in-repo RData reader
(:mod:`._rdata`) instead of pyreadr (reference: io/_scevan.py:88-92).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

from .._util import warn
from ._rdata import read_rdata

__all__ = ["read_scevan"]


def _get_chr_pos_from_array(chr_pos_array):
    """First column index of each chromosome (reference: io/_scevan.py:12-23)."""
    chr_pos = {}
    for i, sn in enumerate(chr_pos_array):
        chr_name = f"chr{int(sn)}"
        if chr_name not in chr_pos:
            chr_pos[chr_name] = i
    return chr_pos


def read_scevan(
    adata,
    scevan_res_dir,
    scevan_res_table=None,
    *,
    subclones: bool = True,
    inplace: bool = True,
    subset: bool = True,
    key_added: str = "scevan",
):
    """Load SCEVAN results for downstream analysis (reference: io/_scevan.py:26-115)."""
    scevan_res_dir = Path(scevan_res_dir)
    scevan_res_file = list(scevan_res_dir.glob("*_CNAmtx.RData"))
    scevan_subclones_file = list(scevan_res_dir.glob("*_CNAmtxSubclones.RData"))
    scevan_anno_file = list(scevan_res_dir.glob("*_count_mtx_annot.RData"))

    if len(scevan_res_file) != 1 or len(scevan_subclones_file) > 1 or len(scevan_anno_file) != 1:
        raise ValueError(
            "Expected the SCEVAN output directory to contain one *_CNAmtx.RData, one "
            "*_count_mtx_annot.RData, and at most one *_CNAmtxSubclones.RData file."
        )

    if scevan_res_table is not None:
        tumor_normal_call = pd.read_csv(scevan_res_table, index_col=0)
    else:
        tumor_normal_call = None
        warn("No `scevan_res_table` specified. Will not add tumor/normal classification.")

    scevan_res = read_rdata(scevan_res_file[0])["CNA_mtx_relat"].T
    scevan_anno = read_rdata(scevan_anno_file[0])["count_mtx_annot"]
    scevan_subclone_res = None
    if subclones and len(scevan_subclones_file):
        scevan_subclone_res = read_rdata(scevan_subclones_file[0])["results.com"].T

    if not inplace:
        adata = adata.copy()

    if tumor_normal_call is not None:
        adata.obs[f"{key_added}_class"] = tumor_normal_call.reindex(adata.obs_names)["class"].values
        adata.obs[f"{key_added}_confident_normal"] = tumor_normal_call.reindex(adata.obs_names)[
            "confidentNormal"
        ].values
        if "subclone" in tumor_normal_call.columns:
            adata.obs[f"{key_added}_subclone"] = (
                tumor_normal_call.reindex(adata.obs_names)["subclone"]
                .apply(lambda x: f"{int(x)}" if not pd.isnull(x) else np.nan)
                .values
            )

    if subset:
        adata._inplace_subset_obs(scevan_res.index.values)

    cnmat = scevan_res.reindex(adata.obs_names)
    if scevan_subclone_res is not None:
        common = cnmat.index.intersection(scevan_subclone_res.index)
        cnmat.loc[common, :] = scevan_subclone_res.loc[common, :].values
    adata.obsm[f"X_{key_added}"] = cnmat.values
    adata.uns[key_added] = {"chr_pos": _get_chr_pos_from_array(scevan_anno["seqnames"])}

    if not inplace:
        return adata
    return None
