"""h5ad read/write compatible with the anndata on-disk format (v0.1.0 encodings).

Standalone replacement for ``anndata.read_h5ad`` / ``AnnData.write`` so the
framework can exchange files with the scanpy ecosystem without depending on it
(the reference gets this from the anndata package; see SURVEY.md §0).

Supported encodings: array, string-array, csr/csc matrix, dataframe,
categorical, dict, numeric-scalar, string, nullable booleans/integers (read as
plain arrays with NaN where masked).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import scipy.sparse as sp

from .anndata import AnnData, Raw

__all__ = ["read_h5ad", "write_h5ad"]

_STR_DT = None


def _h5py():
    import h5py

    return h5py


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _set_enc(obj, enc_type: str, version: str = "0.2.0"):
    obj.attrs["encoding-type"] = enc_type
    obj.attrs["encoding-version"] = version


def _write_array(group, key: str, value, compression=None):
    h5py = _h5py()
    value = np.asarray(value)
    if value.dtype.kind in ("U", "O"):
        dt = h5py.string_dtype(encoding="utf-8")
        arr = np.asarray([("" if x is None or (isinstance(x, float) and np.isnan(x)) else str(x)) for x in value.ravel()], dtype=object).reshape(value.shape)
        ds = group.create_dataset(key, data=arr, dtype=dt, compression=compression)
        _set_enc(ds, "string-array")
    elif value.dtype.kind == "b":
        ds = group.create_dataset(key, data=value, compression=compression)
        _set_enc(ds, "array")
    else:
        ds = group.create_dataset(key, data=value, compression=compression)
        _set_enc(ds, "array")
    return ds


def _write_sparse(group, key: str, mtx, compression=None):
    fmt = "csr_matrix" if sp.issparse(mtx) and mtx.format == "csr" else "csc_matrix"
    m = mtx.tocsr() if fmt == "csr_matrix" else mtx.tocsc()
    g = group.create_group(key)
    _set_enc(g, fmt, "0.1.0")
    g.attrs["shape"] = np.array(m.shape, dtype=np.int64)
    g.create_dataset("data", data=m.data, compression=compression)
    g.create_dataset("indices", data=m.indices, compression=compression)
    g.create_dataset("indptr", data=m.indptr, compression=compression)


def _write_categorical(group, key: str, value: pd.Categorical, compression=None):
    g = group.create_group(key)
    _set_enc(g, "categorical")
    g.attrs["ordered"] = bool(value.ordered)
    _write_array(g, "categories", np.asarray(value.categories), compression)
    g.create_dataset("codes", data=np.asarray(value.codes, dtype=np.int64), compression=compression)


def _write_dataframe(group, key: str, df: pd.DataFrame, compression=None):
    g = group.create_group(key)
    _set_enc(g, "dataframe", "0.2.0")
    index_name = df.index.name if df.index.name else "_index"
    g.attrs["_index"] = index_name
    g.attrs["column-order"] = np.asarray(list(df.columns), dtype=object) if len(df.columns) else np.array([], dtype="S")
    _write_array(g, index_name, df.index.values, compression)
    for col in df.columns:
        _write_value(g, str(col), df[col].values if not isinstance(df[col].dtype, pd.CategoricalDtype) else df[col].cat, compression)


def _write_value(group, key: str, value, compression=None):
    if isinstance(value, pd.DataFrame):
        _write_dataframe(group, key, value, compression)
    elif isinstance(value, (pd.Categorical,)) or hasattr(value, "categories") and hasattr(value, "codes"):
        cat = value if isinstance(value, pd.Categorical) else pd.Categorical.from_codes(np.asarray(value.codes), categories=np.asarray(value.categories))
        _write_categorical(group, key, cat, compression)
    elif sp.issparse(value):
        _write_sparse(group, key, value, compression)
    elif isinstance(value, dict):
        g = group.create_group(key)
        _set_enc(g, "dict", "0.1.0")
        for k, v in value.items():
            _write_value(g, str(k), v, compression)
    elif isinstance(value, str):
        ds = group.create_dataset(key, data=value)
        _set_enc(ds, "string")
    elif np.isscalar(value):
        ds = group.create_dataset(key, data=value)
        _set_enc(ds, "numeric-scalar")
    elif value is None:
        pass
    else:
        _write_array(group, key, np.asarray(value), compression)


def write_h5ad(filename, adata: AnnData, compression=None):
    """Write an :class:`AnnData` to an anndata-spec h5ad file."""
    h5py = _h5py()
    with h5py.File(filename, "w") as f:
        _set_enc(f, "anndata", "0.1.0")
        if adata.X is not None:
            _write_value(f, "X", adata.X, compression)
        _write_dataframe(f, "obs", adata.obs, compression)
        _write_dataframe(f, "var", adata.var, compression)
        for slot in ("obsm", "varm", "layers", "obsp"):
            g = f.create_group(slot)
            _set_enc(g, "dict", "0.1.0")
            for k, v in getattr(adata, slot).items():
                _write_value(g, k, v, compression)
        g = f.create_group("uns")
        _set_enc(g, "dict", "0.1.0")
        for k, v in adata.uns.items():
            _write_value(g, k, v, compression)
        if adata.raw is not None:
            rg = f.create_group("raw")
            _set_enc(rg, "dict", "0.1.0")
            _write_value(rg, "X", adata.raw.X, compression)
            _write_dataframe(rg, "var", adata.raw.var, compression)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def _decode_strings(arr):
    arr = np.asarray(arr)
    if arr.dtype.kind == "S" or arr.dtype == object:
        return np.asarray([x.decode("utf-8") if isinstance(x, bytes) else x for x in arr.ravel()], dtype=object).reshape(arr.shape)
    return arr


def _read_value(obj):
    h5py = _h5py()
    enc = obj.attrs.get("encoding-type", None)
    if isinstance(enc, bytes):
        enc = enc.decode()
    if isinstance(obj, h5py.Dataset):
        value = obj[()]
        if enc == "string":
            return value.decode("utf-8") if isinstance(value, bytes) else str(value)
        if enc == "numeric-scalar" or np.isscalar(value) and not isinstance(value, (bytes, str)):
            if isinstance(value, bytes):
                return value.decode("utf-8")
            return value
        if isinstance(value, bytes):
            return value.decode("utf-8")
        if isinstance(value, np.ndarray):
            return _decode_strings(value)
        return value
    # group
    if enc in ("csr_matrix", "csc_matrix") or ("data" in obj and "indices" in obj and "indptr" in obj):
        shape = tuple(obj.attrs.get("shape", obj.attrs.get("h5sparse_shape")))
        data, indices, indptr = obj["data"][()], obj["indices"][()], obj["indptr"][()]
        fmt = enc or (obj.attrs.get("h5sparse_format", b"csr").decode() + "_matrix")
        cls = sp.csr_matrix if fmt.startswith("csr") else sp.csc_matrix
        return cls((data, indices, indptr), shape=shape)
    if enc == "categorical" or ("categories" in obj and "codes" in obj):
        cats = _decode_strings(obj["categories"][()])
        codes = obj["codes"][()]
        return pd.Categorical.from_codes(codes, categories=pd.Index(cats), ordered=bool(obj.attrs.get("ordered", False)))
    if enc == "dataframe" or "_index" in obj.attrs:
        index_key = obj.attrs["_index"]
        if isinstance(index_key, bytes):
            index_key = index_key.decode()
        col_order = obj.attrs.get("column-order", [])
        cols = [c.decode() if isinstance(c, bytes) else str(c) for c in np.asarray(col_order).ravel()]
        index = _decode_strings(_read_value(obj[index_key]))
        df = pd.DataFrame(index=pd.Index(index, name=None if index_key == "_index" else index_key))
        for c in cols:
            if c == index_key:
                continue
            v = _read_value(obj[c])
            df[c] = v
        return df
    if enc in ("nullable-integer", "nullable-boolean"):
        values = obj["values"][()].astype(float)
        mask = obj["mask"][()]
        values[mask.astype(bool)] = np.nan
        return values
    # plain dict group
    return {k: _read_value(obj[k]) for k in obj.keys()}


def read_h5ad(filename) -> AnnData:
    """Read an h5ad file into the standalone :class:`AnnData` container."""
    h5py = _h5py()
    with h5py.File(filename, "r") as f:
        X = _read_value(f["X"]) if "X" in f else None
        obs = _read_value(f["obs"]) if "obs" in f else None
        var = _read_value(f["var"]) if "var" in f else None
        uns = _read_value(f["uns"]) if "uns" in f else {}
        mappings = {}
        for slot in ("obsm", "varm", "layers", "obsp"):
            mappings[slot] = _read_value(f[slot]) if slot in f else {}
        raw = None
        if "raw" in f:
            rX = _read_value(f["raw"]["X"]) if "X" in f["raw"] else None
            rvar = _read_value(f["raw"]["var"]) if "var" in f["raw"] else None
            if rX is not None:
                raw = Raw(rX, rvar if rvar is not None else pd.DataFrame(), pd.Index(obs.index if obs is not None else []))
    adata = AnnData(X=X, obs=obs, var=var, uns=uns if isinstance(uns, dict) else {}, raw=raw)
    for slot in ("obsm", "varm", "layers", "obsp"):
        target = getattr(adata, slot)
        for k, v in mappings[slot].items():
            if isinstance(v, pd.DataFrame):
                v = v.values
            target[k] = v
    return adata
