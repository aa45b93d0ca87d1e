"""Scores to summarise and assess copy number variation (counterpart of ``infercnvpy_tpu/tl/_scores.py``).

Behavioural contract follows reference tl/_scores.py:
* ``cnv_score``  — per-cluster mean of \\|X_cnv\\| broadcast to cells (:14-74);
  host numpy, as the JAX package computes it on one device, so the values
  are the same;
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

from .._util import _choose_mtx_rep, pick_device

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
) -> Mapping[Any, np.number] | None:
    """Assign each cnv cluster a CNV score (mean |CNV| per cluster); host only.

    Reference: tl/_scores.py:14-74.
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
    groups = adata.obs[groupby].values
    cluster_score = {}
    for cluster in adata.obs[groupby].unique():
        mask = np.asarray(groups == cluster)
        sub = X[mask, :]
        if sp.issparse(sub):
            # mean of |values| over the FULL dense extent (zeros count)
            cluster_score[cluster] = np.abs(sub).sum() / (sub.shape[0] * sub.shape[1])
        else:
            cluster_score[cluster] = np.mean(np.abs(np.asarray(sub)))

    if inplace:
        score_array = np.array([cluster_score[c] for c in adata.obs[groupby]])
        adata.obs[key_added] = score_array
        return None
    return cluster_score


def _pearson_corr(X: np.ndarray, device) -> np.ndarray:
    """Pairwise Pearson correlation of rows (np.corrcoef semantics)."""
    X = np.asarray(X, dtype=np.float64)
    if X.shape[0] * X.shape[1] >= _DEVICE_MIN_ELEMENTS:
        from ..ops.corr import pearson_rows

        return pearson_rows(X, device=device)
    return np.corrcoef(X, rowvar=True)


def _ith_score(adata, groupby: str, get_matrix, device) -> dict:
    groups = adata.obs[groupby].unique()
    out = {}
    for group in groups:
        mask = np.asarray(adata.obs[groupby].values == group)
        X = get_matrix(mask)
        if sp.issparse(X):
            X = np.asarray(X.todense())
        if X.shape[0] <= 1:
            continue
        pcorr = _pearson_corr(X, device)
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

    Reference: tl/_scores.py:77-151.  ``device=None`` is the CUDA device.
    """
    dev = pick_device(device, "tl.ithgex")
    scores = _ith_score(adata, groupby, lambda mask: _choose_mtx_rep(adata[mask, :], use_raw, layer), dev)
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

    Reference: tl/_scores.py:154-221.  ``device=None`` is the CUDA device.
    """
    dev = pick_device(device, "tl.ithcna")
    scores = _ith_score(adata, groupby, lambda mask: adata.obsm[use_rep][mask, :], dev)
    return _store_scores(adata, groupby, scores, key_added) if inplace else scores


def _store_scores(adata, groupby, scores, key_added):
    obs_vals = np.empty(adata.shape[0])
    for group in adata.obs[groupby].unique():
        obs_vals[np.asarray(adata.obs[groupby].values == group)] = scores.get(group, np.nan)
    adata.obs[key_added] = obs_vals
    return None
