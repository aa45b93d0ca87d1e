"""infercnvpy's ``tl.infercnv`` written out plainly, in float64 (reference: tl/_infercnv.py:18-457).

1. reference means: the mean of each reference category's cells, per gene;
2. centring: one category, ``x - ref``; several, the bounded log fold change
   (0 between the categories' least and largest mean, else the distance to
   the nearer bound); then clipped to ``±lfc_clip``;
3. smoothing: per chromosome (natural order, ``chr*`` but ``chrM``), genes
   sorted by start; with more genes than the window, the pyramid-weighted
   means of the windows starting at every ``step``-th gene ('valid' windows);
   otherwise the chromosome's plain mean, one window;
4. each cell minus its median window;
5. the noise gate: zero where ``|x| < dynamic_threshold * std(chunk)``, the
   std over all values of each chunk of ``chunksize`` consecutive cells.

Step 3 is one product with a (genes x windows) weight matrix built here.
Rows are computed chunk by chunk on any torch device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np


def natural_sort(items) -> list[str]:
    def key(s):
        return [int(c) if c.isdigit() else c.lower() for c in re.split(r"([0-9]+)", s)]

    return sorted(items, key=key)


@dataclass
class Windows:
    weights: np.ndarray  # (genes of the masked var, windows) float64
    chr_pos: dict  # chromosome -> its first window
    n_genes_used: int  # genes that lie in some window's chromosome


def window_weights(var, window_size: int, step: int) -> Windows:
    """The smoothing of step 3 as a weight matrix over ``var``'s rows (the masked gene axis)."""
    chrom = var["chromosome"].astype(str).to_numpy()
    chromosomes = natural_sort([c for c in dict.fromkeys(chrom) if c.startswith("chr") and c != "chrM"])
    r = np.arange(1, window_size + 1)
    pyramid = np.minimum(r, r[::-1]).astype(np.float64)
    pyramid /= pyramid.sum()
    cols, chr_pos, used = [], {}, 0
    rows_of = np.arange(len(var))
    for c in chromosomes:
        on = var["chromosome"].astype(str).to_numpy() == c
        genes = rows_of[on][var.loc[on, "start"].reset_index(drop=True).sort_values().index.to_numpy()]
        used += len(genes)
        chr_pos[c] = len(cols)
        if len(genes) > window_size:
            for lo in range(0, len(genes) - window_size + 1, step):
                cols.append((genes[lo : lo + window_size], pyramid))
        else:
            cols.append((genes, np.full(len(genes), 1.0 / len(genes))))
    W = np.zeros((len(var), len(cols)))
    for j, (g, w) in enumerate(cols):
        W[g, j] = w
    return Windows(weights=W, chr_pos=chr_pos, n_genes_used=used)


def reference_means(X, labels: np.ndarray, cats) -> np.ndarray:
    """(categories, genes) float64 means of each reference category's cells."""
    out = []
    for c in cats:
        rows = X[np.flatnonzero(labels == c)]
        out.append(np.asarray(rows.sum(axis=0, dtype=np.float64)).ravel() / rows.shape[0])
    return np.vstack(out)


def dense_rows(X, lo: int, hi: int, device, dtype):
    """Rows ``lo:hi`` of the CSR ``X`` as a dense torch tensor on ``device``."""
    import torch

    ptr = X.indptr
    a, b = int(ptr[lo]), int(ptr[hi])
    counts = torch.from_numpy(np.diff(ptr[lo : hi + 1]).astype(np.int64)).to(device)
    rows = torch.repeat_interleave(torch.arange(hi - lo, device=device), counts)
    cols = torch.from_numpy(X.indices[a:b].astype(np.int64)).to(device)
    vals = torch.from_numpy(X.data[a:b]).to(device=device, dtype=dtype)
    out = torch.zeros((hi - lo, X.shape[1]), dtype=dtype, device=device)
    out.index_put_((rows, cols), vals, accumulate=True)
    return out


def row_median(x):
    """``np.median`` along rows: the mean of the two middle values for an even count."""
    s = x.sort(dim=1).values
    n = x.shape[1]
    return (s[:, (n - 1) // 2] + s[:, n // 2]) / 2


@dataclass
class Params:
    window_size: int = 100
    step: int = 10
    lfc_clip: float = 3.0
    dynamic_threshold: float | None = 1.5
    exclude_chromosomes: tuple = ("chrX", "chrY")
    chunksize: int = 5000


class Reference:
    """The reference of one AnnData-like input: ``X`` (CSR), ``var``, the labels and the reference categories.

    :meth:`chunks` yields, chunk by chunk, ``(lo, hi, x_res, thr)``: the
    ungated median-centred windows of cells ``lo:hi`` and each cell's gate
    threshold (``None`` without a gate), as float64 tensors on ``device``.
    """

    def __init__(self, X, var, labels, reference_cats, params: Params, device):
        import torch

        keep = var["chromosome"].notnull().to_numpy().copy()
        if params.exclude_chromosomes is not None:
            keep &= ~var["chromosome"].isin(list(params.exclude_chromosomes)).to_numpy()
        self.params = params
        self.device = device
        self.X = X[:, np.flatnonzero(keep)].tocsr() if not keep.all() else X
        windows = window_weights(var.loc[keep], params.window_size, params.step)
        self.chr_pos = windows.chr_pos
        self.n_windows = windows.weights.shape[1]
        self.n_genes_used = windows.n_genes_used
        self.W = torch.from_numpy(windows.weights).to(device)
        ref = reference_means(X, np.asarray(labels), reference_cats)[:, keep]
        self.ref = torch.from_numpy(ref).to(device)

    def rows(self, lo: int, hi: int):
        """Steps 1-4 for cells ``lo:hi``."""
        import torch

        x = dense_rows(self.X, lo, hi, self.device, torch.float64)
        if self.ref.shape[0] == 1:
            xc = x - self.ref[0]
        else:
            lo_b, hi_b = self.ref.amin(dim=0), self.ref.amax(dim=0)
            xc = torch.where(x > hi_b, x - hi_b, torch.where(x < lo_b, x - lo_b, torch.zeros_like(x)))
        del x
        xc.clamp_(-self.params.lfc_clip, self.params.lfc_clip)
        smoothed = xc @ self.W
        return smoothed - row_median(smoothed)[:, None]

    def chunks(self):
        n = self.X.shape[0]
        size = self.params.chunksize
        for lo in range(0, n, size):
            hi = min(n, lo + size)
            x_res = self.rows(lo, hi)
            thr = None
            if self.params.dynamic_threshold is not None:
                thr = self.params.dynamic_threshold * x_res.std(unbiased=False)
            yield lo, hi, x_res, thr
