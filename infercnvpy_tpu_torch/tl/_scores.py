"""Scores to summarise and assess copy number variation (counterpart of ``infercnvpy_tpu/tl/_scores.py``).

Behavioural contract follows reference tl/_scores.py:
* ``cnv_score``  — per-cluster mean of \\|X_cnv\\| broadcast to cells (:14-74);
  ``device=None`` is the CUDA device, as for every other downstream entry
  point: each device sums |X| of its rows in float64 and the host adds each
  group's row sums (the JAX package's ``mesh`` branch,
  ``infercnvpy_tpu/tl/_scores.py:32-88``); ``device="cpu"`` is host numpy,
  as the JAX package computes it without a mesh;
* ``ithgex``     — per-group IQR of pairwise Pearson correlations of
  expression (:77-151);
* ``ithcna``     — the same on the CNV matrix (:154-221).

The correlation matrix of a group large enough to benefit is computed in
float64 on the device (``ops.corr.pearson_rows``); smaller groups use
``np.corrcoef``.  The quartiles are ``np.percentile`` on the host over the
float64 matrix.
"""

from __future__ import annotations

import warnings
from collections.abc import Mapping
from typing import Any

import numpy as np
import scipy.sparse as sp
import torch

from .. import profiling
from .._util import _choose_mtx_rep, pick_shards
from ..parallel.mesh import shard_rows

__all__ = ["cnv_score", "ithcna", "ithgex"]

_DEVICE_MIN_ELEMENTS = 512 * 512  # below this, the device round trip is not worth it


def cnv_score(
    adata,
    groupby: str = "cnv_leiden",
    *,
    use_rep: str = "cnv",
    key_added: str = "cnv_score",
    inplace: bool = True,
    obs_key=None,
    device=None,
) -> Mapping[Any, np.number] | None:
    """Assign each cnv cluster a CNV score (mean |CNV| per cluster).

    Reference: tl/_scores.py:14-74.  ``device=None`` is the CUDA device; it,
    any other device, or a list of devices over which the cells are split,
    sums |X| on the devices in float64 (:func:`_group_abs_mean_sharded`).
    ``device="cpu"`` computes on the host with numpy, cluster by cluster.
    """
    if obs_key is not None:
        warnings.warn(
            "The obs_key argument has been renamed to `groupby` for consistency with "
            "other functions and will be removed in the future. ",
            category=FutureWarning,
            stacklevel=2,
        )
        groupby = obs_key

    if groupby not in adata.obs.columns and groupby == "cnv_leiden":
        raise ValueError("`cnv_leiden` not found in `adata.obs`. Did you run `tl.leiden`?")

    X = adata.obsm[f"X_{use_rep}"]
    with profiling.span("cnv_score", cells=X.shape[0]):
        groups = adata.obs[groupby].values
        uniques = list(adata.obs[groupby].unique())
        if not _on_host(device):
            devices = pick_shards(device, "tl.cnv_score")
            code_of = {g: i for i, g in enumerate(uniques)}
            codes = np.fromiter((code_of[g] for g in np.asarray(groups)), dtype=np.int64, count=len(groups))
            means = _group_abs_mean_sharded(X, codes, len(uniques), devices)
            cluster_score = {g: means[i] for i, g in enumerate(uniques)}
        else:
            cluster_score = {}
            for cluster in uniques:
                mask = np.asarray(groups == cluster)
                sub = X[mask, :]
                if sp.issparse(sub):
                    # mean of |values| over the FULL dense extent (zeros count)
                    cluster_score[cluster] = np.abs(sub).sum() / (sub.shape[0] * sub.shape[1])
                else:
                    cluster_score[cluster] = np.mean(np.abs(np.asarray(sub)))
        if inplace:
            adata.obs[key_added] = np.array([cluster_score[c] for c in adata.obs[groupby]])
    return None if inplace else cluster_score


def _on_host(device) -> bool:
    """Whether ``device`` names the CPU alone (not in a list): ``cnv_score``'s host numpy path."""
    return device is not None and not isinstance(device, (list, tuple)) and torch.device(device).type == "cpu"


def _group_abs_mean_sharded(X, codes: np.ndarray, n_groups: int, devices: list, block_rows: int = 65536):
    """Per-group mean |X| with the cells split over ``devices``; float64 (n_groups,).

    Each row block is split into one contiguous shard a device; every device
    sums |x| of each of its rows in float64 (a CSR shard's stored values
    alone, by ``segment_reduce`` over its rows; any other block densified on
    the host first), and the host adds each group's row sums in float64
    (the JAX package's ``_group_abs_mean_sharded``,
    ``infercnvpy_tpu/tl/_scores.py:59-88``, where each device sums its
    groups).  No sum uses atomics, so a rerun gives the same bits.
    """
    n, d = X.shape
    csr = sp.issparse(X) and X.format == "csr"
    row_abs = np.empty(n)
    for start in range(0, n, block_rows):
        stop = min(n, start + block_rows)
        if not csr:
            blk = X[start:stop]
            blk = np.ascontiguousarray(blk.toarray() if sp.issparse(blk) else np.asarray(blk))
        parts = []
        for dev, (lo, hi) in zip(devices, shard_rows(stop - start, len(devices))):
            if csr:
                a, b = X.indptr[start + lo], X.indptr[start + hi]
                vals = torch.from_numpy(np.ascontiguousarray(X.data[a:b])).to(dev).abs().double()
                lengths = torch.from_numpy(np.diff(X.indptr[start + lo : start + hi + 1]).astype(np.int64)).to(dev)
                part = torch.segment_reduce(vals, "sum", lengths=lengths)
            else:
                part = torch.from_numpy(blk[lo:hi]).to(dev).abs().sum(dim=1, dtype=torch.float64)
            parts.append((start + lo, start + hi, part))
        for lo, hi, part in parts:
            row_abs[lo:hi] = part.cpu().numpy()
    sums = np.bincount(codes, weights=row_abs, minlength=n_groups)
    counts = np.bincount(codes, minlength=n_groups).astype(np.float64)
    return sums / np.maximum(counts * d, 1.0)


def _pearson_corr(X: np.ndarray, devices: list) -> np.ndarray:
    """Pairwise Pearson correlation of rows (np.corrcoef semantics).

    On the devices for a large group or a list of several devices (as the
    JAX package takes its mesh whenever one is given), else ``np.corrcoef``.
    """
    X = np.asarray(X, dtype=np.float64)
    if len(devices) > 1 or X.shape[0] * X.shape[1] >= _DEVICE_MIN_ELEMENTS:
        from ..ops.corr import pearson_rows

        return pearson_rows(X, device=devices)
    return np.corrcoef(X, rowvar=True)


def _ith_score(adata, groupby: str, get_matrix, devices: list) -> dict:
    groups = adata.obs[groupby].unique()
    out = {}
    for group in groups:
        mask = np.asarray(adata.obs[groupby].values == group)
        X = get_matrix(mask)
        if sp.issparse(X):
            X = np.asarray(X.todense())
        if X.shape[0] <= 1:
            continue
        pcorr = _pearson_corr(X, devices)
        q75, q25 = np.percentile(pcorr, [75, 25])
        out[group] = q75 - q25
    return out


def ithgex(
    adata,
    groupby: str,
    *,
    use_raw: bool | None = None,
    layer: str | None = None,
    inplace: bool = True,
    key_added: str = "ithgex",
    device=None,
) -> Mapping[str, float] | None:
    """ITHGEX diversity score based on gene expression (Wu2021).

    Reference: tl/_scores.py:77-151.  ``device=None`` is the CUDA device; a
    list of devices splits each group's correlation product into row stripes
    (``ops.corr.pearson_rows``).
    """
    devices = pick_shards(device, "tl.ithgex")
    scores = _ith_score(adata, groupby, lambda mask: _choose_mtx_rep(adata[mask, :], use_raw, layer), devices)
    return _store_scores(adata, groupby, scores, key_added) if inplace else scores


def ithcna(
    adata,
    groupby: str,
    *,
    use_rep: str = "X_cnv",
    key_added: str = "ithcna",
    inplace: bool = True,
    device=None,
) -> Mapping[str, float] | None:
    """ITHCNA diversity score based on copy number variation (Wu2021).

    Reference: tl/_scores.py:154-221.  ``device`` as in :func:`ithgex`.
    """
    devices = pick_shards(device, "tl.ithcna")
    scores = _ith_score(adata, groupby, lambda mask: adata.obsm[use_rep][mask, :], devices)
    return _store_scores(adata, groupby, scores, key_added) if inplace else scores


def _store_scores(adata, groupby, scores, key_added):
    obs_vals = np.empty(adata.shape[0])
    for group in adata.obs[groupby].unique():
        obs_vals[np.asarray(adata.obs[groupby].values == group)] = scores.get(group, np.nan)
    adata.obs[key_added] = obs_vals
    return None
