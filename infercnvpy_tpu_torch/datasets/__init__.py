"""Example datasets (copied from ``infercnvpy_tpu.datasets``).

* :func:`synthetic_cnv_dataset` generates a deterministic scRNA-seq dataset
  with injected chromosome-scale CNV events;
* :func:`oligodendroglioma` loads the bundled 183-cell h5ad when present, else
  generates a synthetic stand-in with the same structure and caches it;
* :func:`maynard2020_3k` loads the cached download, else downloads it from
  the reference's release URL, else raises (or generates synthetic data when
  ``allow_synthetic=True``).

All three are byte-for-byte the JAX package's, so the same seed gives the
same data in both packages.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd
import scipy.sparse as sp

from .. import settings
from .._util import warn
from ..core import AnnData, read_h5ad

__all__ = ["oligodendroglioma", "maynard2020_3k", "synthetic_cnv_dataset"]

_DATA_DIR = Path(__file__).parent / "data"

# rough hg38 chromosome lengths (Mb) for synthetic gene placement
_CHR_MB = {
    "chr1": 248, "chr2": 242, "chr3": 198, "chr4": 190, "chr5": 181, "chr6": 171,
    "chr7": 159, "chr8": 145, "chr9": 138, "chr10": 134, "chr11": 135, "chr12": 133,
    "chr13": 114, "chr14": 107, "chr15": 102, "chr16": 90, "chr17": 83, "chr18": 80,
    "chr19": 59, "chr20": 64, "chr21": 47, "chr22": 51, "chrX": 156, "chrY": 57,
}


def synthetic_cnv_dataset(
    n_cells: int = 183,
    n_genes: int = 4000,
    *,
    seed: int = 0,
    malignant_fraction: float = 0.6,
    cell_types: tuple[str, ...] = ("Malignant", "Microglia/Macrophage", "Oligodendrocytes (non-malignant)"),
    cnv_events: dict | None = None,
    sparse_format=sp.csr_matrix,
) -> AnnData:
    """Deterministic synthetic scRNA-seq dataset with injected CNV events.

    Expression is log1p-normalized-like (lognormal), genes carry full
    chromosome/start/end annotations, and malignant cells receive
    chromosome-scale expression shifts (default: chr1 deletion, chr19+chr20
    amplification — the oligodendroglioma 1p/19q-like signature).
    """
    rng = np.random.default_rng(seed)
    if cnv_events is None:
        cnv_events = {"chr1": -0.45, "chr19": 0.45, "chr20": 0.35}

    # gene placement proportional to chromosome length
    chroms = list(_CHR_MB.keys())
    probs = np.array([_CHR_MB[c] for c in chroms], dtype=float)
    probs /= probs.sum()
    gene_chrom = rng.choice(len(chroms), size=n_genes, p=probs)
    starts = np.empty(n_genes, dtype=np.int64)
    for ci, c in enumerate(chroms):
        mask = gene_chrom == ci
        n_c = int(mask.sum())
        starts[mask] = np.sort(rng.integers(1, _CHR_MB[c] * 1_000_000, size=n_c))
    var = pd.DataFrame(
        {
            "chromosome": [chroms[i] for i in gene_chrom],
            "start": starts,
            "end": starts + rng.integers(1_000, 100_000, size=n_genes),
        },
        index=pd.Index([f"gene_{i}" for i in range(n_genes)]),
    )

    n_mal = int(round(n_cells * malignant_fraction))
    n_rest = n_cells - n_mal
    per_normal = [n_rest // (len(cell_types) - 1)] * (len(cell_types) - 1)
    per_normal[-1] += n_rest - sum(per_normal)
    labels = [cell_types[0]] * n_mal
    for ct, k in zip(cell_types[1:], per_normal):
        labels += [ct] * k
    perm = rng.permutation(n_cells)
    labels = np.asarray(labels, dtype=object)[perm]

    # baseline expression: per-gene mean + cell-type effect + noise (log-space)
    gene_mean = rng.gamma(2.0, 0.5, size=n_genes)
    type_effect = {ct: rng.normal(0, 0.2, size=n_genes) for ct in cell_types}
    X = np.empty((n_cells, n_genes), dtype=np.float32)
    for i in range(n_cells):
        mu = gene_mean + type_effect[labels[i]]
        X[i] = np.maximum(0.0, mu + rng.normal(0, 0.35, size=n_genes)).astype(np.float32)

    # inject CNV events into malignant cells
    mal_mask = labels == cell_types[0]
    for chrom, shift in cnv_events.items():
        gmask = (var["chromosome"] == chrom).values
        X[np.ix_(mal_mask, gmask)] = np.maximum(0.0, X[np.ix_(mal_mask, gmask)] + shift)

    # sprinkle dropout so sparse storage is meaningful
    X[rng.random(X.shape) < 0.35] = 0.0

    obs = pd.DataFrame(
        {"cell_type": pd.Categorical(labels, categories=list(cell_types))},
        index=pd.Index([f"cell_{i}" for i in range(n_cells)]),
    )
    adata = AnnData(X=sparse_format(X) if sparse_format is not None else X, obs=obs, var=var)
    adata.uns["synthetic"] = {"seed": seed, "cnv_events": cnv_events}
    return adata


def oligodendroglioma() -> AnnData:
    """The oligodendroglioma example dataset (Tirosh 2016 in the reference).

    Reference: datasets/__init__.py:13-19.  The original h5ad blob is not
    shipped in this build; if ``datasets/data/oligodendroglioma.h5ad`` exists
    it is loaded, otherwise a deterministic synthetic dataset with the same
    structure is generated (and a warning emitted).
    """
    bundled = _DATA_DIR / "oligodendroglioma.h5ad"
    if bundled.exists():
        return read_h5ad(bundled)
    cached = settings.datasetdir / "oligodendroglioma_synthetic.h5ad"
    if cached.exists():
        return read_h5ad(cached)
    warn("Bundled oligodendroglioma.h5ad not available — generating a deterministic synthetic stand-in.")
    adata = synthetic_cnv_dataset(n_cells=183, n_genes=4000, seed=0)
    try:
        settings.datasetdir.mkdir(parents=True, exist_ok=True)
        adata.write_h5ad(cached)
    except Exception:
        pass
    return adata


def maynard2020_3k(*, allow_synthetic: bool = False) -> AnnData:
    """Maynard 2020 lung-cancer dataset, 3000 cells (reference: datasets/__init__.py:22-41).

    Downloads from the reference's release URL on first use.  With
    ``allow_synthetic=True`` a 3000-cell synthetic dataset is generated when
    the download is impossible (offline environments).
    """
    url = "https://github.com/icbi-lab/infercnvpy/releases/download/d0.1.0/maynard2020_3k.h5ad"
    filename = settings.datasetdir / "maynard2020_3k.h5ad"
    if filename.exists():
        return read_h5ad(filename)
    try:
        import urllib.request

        settings.datasetdir.mkdir(parents=True, exist_ok=True)
        urllib.request.urlretrieve(url, filename)  # noqa: S310
        return read_h5ad(filename)
    except Exception as e:
        if allow_synthetic:
            warn(f"Download failed ({e}); generating a synthetic 3000-cell stand-in.")
            return synthetic_cnv_dataset(n_cells=3000, n_genes=6000, seed=2020)
        raise RuntimeError(
            f"Could not download {url} ({e}). Place the file at {filename} manually, "
            "or call with allow_synthetic=True."
        ) from e
