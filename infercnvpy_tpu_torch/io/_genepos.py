"""Genomic gene-position annotation from GTF files or ENSEMBL Biomart (copied from ``infercnvpy_tpu.io._genepos``).

Behavioral contract follows reference io/_genepos.py:11-179, with an in-repo
GTF parser (the reference uses the optional ``gtfparse``/polars dependency,
:125-133) and a direct Biomart XML query (the reference goes through
``scanpy.queries``, :39-49).  Host code only: nothing here takes a device.
"""

from __future__ import annotations

import gzip
import re
from pathlib import Path
from typing import Literal

import numpy as np
import pandas as pd

from .._util import warn

__all__ = ["genomic_position_from_gtf", "genomic_position_from_biomart", "read_gtf"]

_ATTR_RE = {
    "gene_id": re.compile(r'gene_id "([^"]*)"'),
    "gene_name": re.compile(r'gene_name "([^"]*)"'),
}


def read_gtf(gtf_file, features: set[str] | None = None) -> pd.DataFrame:
    """Parse a (optionally gzipped) GTF file into a DataFrame.

    Returns columns: seqname, feature, start, end, gene_id, gene_name.
    """
    gtf_file = Path(gtf_file)
    opener = gzip.open if str(gtf_file).endswith(".gz") else open
    rows = []
    with opener(gtf_file, "rt") as fh:
        for line in fh:
            if not line or line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 9:
                continue
            seqname, _source, feature, start, end = parts[0], parts[1], parts[2], parts[3], parts[4]
            if features is not None and feature not in features:
                continue
            attrs = parts[8]
            gid = _ATTR_RE["gene_id"].search(attrs)
            gname = _ATTR_RE["gene_name"].search(attrs)
            rows.append(
                (
                    seqname,
                    feature,
                    int(start),
                    int(end),
                    gid.group(1) if gid else "",
                    gname.group(1) if gname else "",
                )
            )
    return pd.DataFrame(rows, columns=["seqname", "feature", "start", "end", "gene_id", "gene_name"])


def _merge_into_var(adata, annot: pd.DataFrame, left_key: str | None, right_key: str, inplace: bool):
    """Left-merge ``annot`` into ``adata.var``, preserving the var index.

    A pandas merge discards the index, so the index is stashed as an interim
    column for the join and restored afterwards (behavior equivalent to
    reference io/_genepos.py:73-91,157-170, which does this twice inline).
    """
    stash = "__var_index__"
    flat = adata.var.copy()
    index_name = flat.index.name
    flat.index.name = stash
    merged = flat.reset_index().merge(
        annot,
        how="left",
        left_on=stash if left_key is None else left_key,
        right_on=right_key,
        validate="one_to_one",
    )
    merged = merged.set_index(stash)
    merged.index.name = index_name

    if inplace:
        adata.var = merged
        return None
    return merged


def genomic_position_from_gtf(
    gtf_file,
    adata=None,
    *,
    gtf_gene_id: Literal["gene_id", "gene_name"] = "gene_name",
    adata_gene_id: str | None = None,
    inplace: bool = True,
) -> pd.DataFrame | None:
    """Get genomic gene positions from a GTF file (reference: io/_genepos.py:94-179)."""
    gtf = read_gtf(gtf_file, features={"gene"})
    gtf = (
        gtf.loc[:, ["seqname", "start", "end", "gene_id", "gene_name"]]
        .drop_duplicates()
        .rename(columns={"seqname": "chromosome"})
    )
    # remove ensembl versions
    gtf["gene_id"] = gtf["gene_id"].str.replace(r"\.\d+$", "", regex=True)

    gene_ids_adata = (adata.var_names if adata_gene_id is None else adata.var[adata_gene_id]).values
    gtf = gtf.loc[gtf[gtf_gene_id].isin(gene_ids_adata), :]

    missing_from_gtf = len(set(gene_ids_adata) - set(gtf[gtf_gene_id].values))
    if missing_from_gtf:
        warn(f"{missing_from_gtf} genes of `adata` have no entry in the GTF file and stay unannotated.")

    duplicated_symbols = np.sum(gtf["gene_name"].duplicated())
    if duplicated_symbols:
        warn(f"Dropped {duplicated_symbols} genes whose identifier appears more than once in the GTF file.")
        gtf = gtf.loc[~gtf[gtf_gene_id].duplicated(keep=False), :]

    var_annotated = _merge_into_var(adata, gtf, adata_gene_id, gtf_gene_id, inplace=False)

    # if not a gencode GTF, add the 'chr' prefix (reference: :172-174)
    if np.all(~var_annotated["chromosome"].dropna().str.startswith("chr")):
        var_annotated["chromosome"] = "chr" + var_annotated["chromosome"]

    if inplace:
        adata.var = var_annotated
        return None
    return var_annotated


_BIOMART_URL = "http://www.ensembl.org/biomart/martservice"

_BIOMART_QUERY = """<?xml version="1.0" encoding="UTF-8"?>
<!DOCTYPE Query>
<Query virtualSchemaName="default" formatter="TSV" header="0" uniqueRows="0" datasetConfigVersion="0.6">
  <Dataset name="{dataset}" interface="default">
    {attributes}
  </Dataset>
</Query>"""


def fetch_biomart_annotations(
    species: str,
    attrs: list[str],
    *,
    url: str = _BIOMART_URL,
    timeout: float = 60.0,
    use_cache: bool = True,
) -> pd.DataFrame:
    """Query ENSEMBL Biomart for gene annotations (network access required).

    ``use_cache=True`` (default) stores each query's result under
    ``settings.datasetdir/biomart`` and serves repeats from disk (the
    reference caches through scanpy, reference: io/_genepos.py:39-49).
    """
    import hashlib
    import io as _io
    import urllib.parse
    import urllib.request

    cache_file = None
    if use_cache:
        from .. import settings

        key = hashlib.sha256(f"{url}|{species}|{','.join(attrs)}".encode()).hexdigest()[:24]
        cache_file = settings.datasetdir / "biomart" / f"{key}.parquet"
        if cache_file.exists():
            return pd.read_parquet(cache_file)

    attr_xml = "\n    ".join(f'<Attribute name="{a}" />' for a in attrs)
    query = _BIOMART_QUERY.format(dataset=f"{species}_gene_ensembl", attributes=attr_xml)
    data = urllib.parse.urlencode({"query": query}).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=timeout) as resp:
        text = resp.read().decode()
    if text.startswith("Query ERROR"):
        raise RuntimeError(f"Biomart query failed: {text[:500]}")
    df = pd.read_csv(_io.StringIO(text), sep="\t", names=attrs)
    if cache_file is not None:
        try:
            cache_file.parent.mkdir(parents=True, exist_ok=True)
            df.to_parquet(cache_file)
        except Exception:  # parquet engine missing / read-only FS: cache is best-effort
            pass
    return df


def genomic_position_from_biomart(
    adata=None,
    *,
    adata_gene_id: str | None = None,
    biomart_gene_id: str = "ensembl_gene_id",
    species: str = "hsapiens",
    inplace: bool = True,
    **kwargs,
):
    """Get genomic gene positions from ENSEMBL Biomart (reference: io/_genepos.py:11-91).

    Requires network access; ``**kwargs`` are passed to
    :func:`fetch_biomart_annotations`.
    """
    biomart_annot = (
        fetch_biomart_annotations(
            species,
            [biomart_gene_id, "start_position", "end_position", "chromosome_name"],
            **kwargs,
        )
        .rename(
            columns={
                "start_position": "start",
                "end_position": "end",
                "chromosome_name": "chromosome",
            }
        )
        .assign(chromosome=lambda x: "chr" + x["chromosome"].astype(str))
    )

    gene_ids_adata = (adata.var_names if adata_gene_id is None else adata.var[adata_gene_id]).values
    missing_from_biomart = len(set(gene_ids_adata) - set(biomart_annot[biomart_gene_id].values))
    if missing_from_biomart:
        warn(f"{missing_from_biomart} genes of `adata` have no Biomart annotation (are the ids ENSEMBL?).")

    duplicated_symbols = np.sum(biomart_annot[biomart_gene_id].duplicated())
    if duplicated_symbols:
        warn(f"Dropped {duplicated_symbols} genes whose identifier maps to more than one Biomart record.")
        biomart_annot = biomart_annot.loc[~biomart_annot[biomart_gene_id].duplicated(keep=False), :]

    return _merge_into_var(adata, biomart_annot, adata_gene_id, biomart_gene_id, inplace)
