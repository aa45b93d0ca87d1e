"""A lightweight, standalone AnnData-compatible container.

Implements the subset of the ``anndata.AnnData`` API that the CNV analysis
stack uses (see SURVEY.md §0 data-model table): the cells×genes matrix ``X``,
annotation DataFrames ``obs``/``var``, aligned mappings ``obsm``/``varm``/
``obsp``/``layers``, the unstructured ``uns`` dict, a minimal ``raw``, and
obs/var subsetting.  Subsetting returns copies (not views) — simpler and
sufficient for this framework's workflows.
"""

from __future__ import annotations

import copy as _copy
from collections.abc import Mapping

import numpy as np
import pandas as pd
import scipy.sparse as sp

__all__ = ["AnnData", "Raw", "AxisArrays"]


def _as_df(value, n: int, default_prefix: str) -> pd.DataFrame:
    """Coerce obs/var input into a DataFrame with a string index of length n."""
    if value is None:
        df = pd.DataFrame(index=pd.Index([str(i) for i in range(n)]))
    elif isinstance(value, pd.DataFrame):
        df = value.copy()
        if isinstance(df.index, pd.RangeIndex) or df.index.dtype.kind in "iu":
            df.index = df.index.astype(str)
    elif isinstance(value, Mapping):
        df = pd.DataFrame(dict(value))
        df.index = df.index.astype(str)
    else:
        raise TypeError(f"Cannot construct {default_prefix} annotation from {type(value)}")
    if len(df) != n:
        raise ValueError(f"{default_prefix} length {len(df)} does not match matrix dim {n}")
    return df


def _subset_matrix(X, oidx, vidx):
    if X is None:
        return None
    if sp.issparse(X):
        # CSC is much faster for column subsetting, CSR for rows; scipy handles both.
        return X[oidx][:, vidx]
    X = np.asarray(X)
    return X[np.ix_(oidx, vidx)] if X.ndim == 2 else X[oidx]


def _normalize_index(index, names: pd.Index):
    """Turn any of (slice, int, str, bool mask, int array, str array) into int positions."""
    n = len(names)
    if isinstance(index, slice):
        return np.arange(n)[index]
    if isinstance(index, (int, np.integer)):
        return np.array([index % n if index < 0 else index])
    if isinstance(index, str):
        loc = names.get_loc(index)
        return np.array([loc]) if isinstance(loc, (int, np.integer)) else np.arange(n)[loc]
    if isinstance(index, pd.Series):
        index = index.values
    index = np.asarray(index)
    if index.dtype == bool:
        if len(index) != n:
            raise IndexError(f"Boolean index length {len(index)} != axis length {n}")
        return np.flatnonzero(index)
    if index.dtype.kind in "iu":
        return index
    # string labels
    return names.get_indexer(pd.Index(index))


class AxisArrays(dict):
    """Dict of arrays aligned to one axis of the parent AnnData (obsm/varm/layers/obsp)."""

    def __init__(self, parent: "AnnData", axis: int, ndim_exact: int | None = None, square: bool = False):
        super().__init__()
        self._parent = parent
        self._axis = axis
        self._square = square
        self._ndim_exact = ndim_exact

    def __setitem__(self, key, value):
        if not isinstance(key, str):
            raise TypeError("Keys must be strings")
        n = self._parent.shape[self._axis]
        vshape = value.shape
        if vshape[0] != n:
            raise ValueError(f"Value for {key!r} has leading dim {vshape[0]}, expected {n}")
        if self._square and (len(vshape) != 2 or vshape[1] != n):
            raise ValueError(f"Value for {key!r} must be a square {n}x{n} matrix")
        super().__setitem__(key, value)

    def copy_for(self, parent: "AnnData", idx=None) -> "AxisArrays":
        new = AxisArrays(parent, self._axis, self._ndim_exact, self._square)
        for k, v in self.items():
            if idx is not None:
                if self._square:
                    v = v[idx][:, idx]
                elif sp.issparse(v):
                    v = v[idx]
                else:
                    v = np.asarray(v)[idx]
            dict.__setitem__(new, k, _copy.copy(v))
        return new


class Raw:
    """Minimal .raw: a frozen (X, var) snapshot (reference: _util.py:12-24 reads raw.X)."""

    def __init__(self, X, var: pd.DataFrame, obs_names: pd.Index):
        self._X = X
        self._var = var
        self._obs_names = obs_names

    @property
    def X(self):
        return self._X

    @property
    def var(self) -> pd.DataFrame:
        return self._var

    @property
    def var_names(self) -> pd.Index:
        return self._var.index

    @property
    def shape(self):
        return (len(self._obs_names), len(self._var))


class AnnData:
    """Annotated data matrix: cells (obs) × genes (var).

    API-compatible subset of ``anndata.AnnData`` — the de-facto IR of the CNV
    stack (SURVEY.md §0).  All public CNV functions read/write conventional
    slots on this object.
    """

    def __init__(
        self,
        X=None,
        obs=None,
        var=None,
        uns: dict | None = None,
        obsm: Mapping | None = None,
        varm: Mapping | None = None,
        layers: Mapping | None = None,
        obsp: Mapping | None = None,
        raw: Raw | None = None,
        shape: tuple[int, int] | None = None,
    ):
        if X is not None:
            if isinstance(X, pd.DataFrame):
                if obs is None:
                    obs = pd.DataFrame(index=X.index.astype(str))
                if var is None:
                    var = pd.DataFrame(index=X.columns.astype(str))
                X = X.values
            if not sp.issparse(X):
                X = np.asarray(X)
                if X.ndim == 1:
                    X = X[None, :]
            n_obs, n_vars = X.shape
        elif shape is not None:
            n_obs, n_vars = shape
        else:
            n_obs = len(obs) if obs is not None else 0
            n_vars = len(var) if var is not None else 0

        self._X = X
        self._obs = _as_df(obs, n_obs, "obs")
        self._var = _as_df(var, n_vars, "var")
        self._uns = dict(uns) if uns is not None else {}
        self._obsm = AxisArrays(self, 0)
        self._varm = AxisArrays(self, 1)
        self._layers = AxisArrays(self, 0)
        self._obsp = AxisArrays(self, 0, square=True)
        self._raw = raw
        for target, source in ((self._obsm, obsm), (self._varm, varm), (self._layers, layers), (self._obsp, obsp)):
            if source:
                for k, v in source.items():
                    target[k] = v

    # -- basic properties ------------------------------------------------
    @property
    def X(self):
        return self._X

    @X.setter
    def X(self, value):
        if value is not None and value.shape != self.shape:
            raise ValueError(f"X shape {value.shape} does not match AnnData shape {self.shape}")
        self._X = value

    @property
    def shape(self) -> tuple[int, int]:
        return (len(self._obs), len(self._var))

    @property
    def n_obs(self) -> int:
        return len(self._obs)

    @property
    def n_vars(self) -> int:
        return len(self._var)

    @property
    def obs(self) -> pd.DataFrame:
        return self._obs

    @obs.setter
    def obs(self, value: pd.DataFrame):
        self._obs = _as_df(value, self.n_obs, "obs")

    @property
    def var(self) -> pd.DataFrame:
        return self._var

    @var.setter
    def var(self, value: pd.DataFrame):
        self._var = _as_df(value, self.n_vars, "var")

    @property
    def obs_names(self) -> pd.Index:
        return self._obs.index

    @obs_names.setter
    def obs_names(self, value):
        self._obs.index = pd.Index(value)

    @property
    def var_names(self) -> pd.Index:
        return self._var.index

    @var_names.setter
    def var_names(self, value):
        self._var.index = pd.Index(value)

    @property
    def uns(self) -> dict:
        return self._uns

    @property
    def obsm(self) -> AxisArrays:
        return self._obsm

    @property
    def varm(self) -> AxisArrays:
        return self._varm

    @property
    def layers(self) -> AxisArrays:
        return self._layers

    @property
    def obsp(self) -> AxisArrays:
        return self._obsp

    @property
    def raw(self) -> Raw | None:
        return self._raw

    @raw.setter
    def raw(self, value):
        if value is None:
            self._raw = None
        elif isinstance(value, Raw):
            self._raw = value
        elif isinstance(value, AnnData):
            self._raw = Raw(value.X, value.var.copy(), value.obs_names)
        else:
            raise TypeError("raw must be an AnnData or Raw object")

    def obsm_keys(self):
        return list(self._obsm.keys())

    def uns_keys(self):
        return list(self._uns.keys())

    # -- subsetting ------------------------------------------------------
    def __getitem__(self, index) -> "AnnData":
        if not isinstance(index, tuple):
            index = (index, slice(None))
        oidx = _normalize_index(index[0], self.obs_names)
        vidx = _normalize_index(index[1], self.var_names)
        new = AnnData(
            X=_subset_matrix(self._X, oidx, vidx),
            obs=self._obs.iloc[oidx].copy(),
            var=self._var.iloc[vidx].copy(),
            uns=_copy.deepcopy(self._uns),
            raw=self._raw,
        )
        for k, v in self._obsm.items():
            new._obsm[k] = v[oidx] if not sp.issparse(v) else v[oidx]
        for k, v in self._varm.items():
            new._varm[k] = v[vidx] if not sp.issparse(v) else v[vidx]
        for k, v in self._layers.items():
            new._layers[k] = _subset_matrix(v, oidx, vidx)
        for k, v in self._obsp.items():
            new._obsp[k] = v[oidx][:, oidx]
        return new

    def _inplace_subset_obs(self, index):
        """Subset observations in place (reference: io/_scevan.py:106-107 relies on this)."""
        sub = self[index, :]
        self._X = sub._X
        self._obs = sub._obs
        self._obsm = sub._obsm.copy_for(self)
        self._layers = sub._layers.copy_for(self)
        self._obsp = sub._obsp.copy_for(self)
        self._uns = sub._uns

    def _inplace_subset_var(self, index):
        sub = self[:, index]
        self._X = sub._X
        self._var = sub._var
        self._varm = sub._varm.copy_for(self)
        self._layers = sub._layers.copy_for(self)

    # -- misc ------------------------------------------------------------
    def copy(self) -> "AnnData":
        new = AnnData(
            X=self._X.copy() if self._X is not None else None,
            obs=self._obs.copy(),
            var=self._var.copy(),
            uns=_copy.deepcopy(self._uns),
            raw=self._raw,
        )
        for src, dst in (
            (self._obsm, new._obsm),
            (self._varm, new._varm),
            (self._layers, new._layers),
            (self._obsp, new._obsp),
        ):
            for k, v in src.items():
                dst[k] = v.copy() if hasattr(v, "copy") else _copy.copy(v)
        return new

    def write_h5ad(self, filename, compression=None):
        from .h5ad import write_h5ad

        write_h5ad(filename, self, compression=compression)

    write = write_h5ad

    def __repr__(self) -> str:
        lines = [f"AnnData object with n_obs × n_vars = {self.n_obs} × {self.n_vars}"]
        for name in ("obs", "var"):
            cols = list(getattr(self, name).columns)
            if cols:
                lines.append(f"    {name}: {', '.join(map(repr, cols))}")
        for name in ("uns", "obsm", "varm", "layers", "obsp"):
            keys = list(getattr(self, name).keys())
            if keys:
                lines.append(f"    {name}: {', '.join(map(repr, keys))}")
        return "\n".join(lines)
