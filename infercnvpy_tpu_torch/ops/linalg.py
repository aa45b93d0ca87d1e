"""Truncated SVD / PCA of the cell × window matrix (counterpart of ``infercnvpy_tpu/ops/linalg.py``).

Replaces the reference's ARPACK path (reference: tl/__init__.py:66-71 calls
``sc.tl.pca(svd_solver="arpack", zero_center=False)``): the (features ×
features) Gram matrix is accumulated on the device over row blocks (a sparse
input of any cell count is densified one block at a time), one float64
``eigh`` of that small matrix on the host gives the components, and the
scores are projected on the device block by block.

Precision: the Gram squares the condition number, so a float32 Gram bounds
the tail eigenvalues at ~2⁻²⁴ · (σ₁/σᵢ)² relative error.  ``high_precision``
runs the Gram, the column sums and the projection in float64 on the device
(the JAX package's x64 branch); the default is float32, the JAX package's
default without x64.  The JAX package's host-BLAS branch for backends
without float64 is not carried: CUDA devices and the CPU have it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .._util import full_f32_matmul, pick_device

__all__ = ["truncated_svd"]


def truncated_svd(
    X,
    n_comps: int,
    *,
    zero_center: bool = False,
    block_rows: int = 16384,
    dtype=np.float32,
    sign_convention: bool = True,
    high_precision: bool = False,
    device=None,
):
    """Top-``n_comps`` principal scores of X (cells × features).

    Returns numpy ``(scores, components, singular_values)`` with
    ``scores[i] = X[i] @ components.T`` — sklearn TruncatedSVD / non-centred
    PCA semantics, as the reference uses.  On the default path the Gram's
    products take ``dtype`` and sum in float32, the scores are float32;
    ``high_precision=True`` computes everything in float64.
    ``device=None`` is the CUDA device.
    """
    dev = pick_device(device, "truncated_svd")
    n, d = X.shape
    n_comps = int(min(n_comps, min(n, d)))
    # the Gram's products in ``dtype`` (float64 with high_precision), summed in float32 (float64)
    acc_np = np.float64 if high_precision else np.float32
    acc = torch.float64 if high_precision else torch.float32
    gram_np = np.float64 if high_precision else np.dtype(dtype)

    def _blocks(np_dtype):
        for start in range(0, n, block_rows):
            blk = X[start : start + block_rows]
            blk = blk.toarray() if sp.issparse(blk) else np.asarray(blk)
            yield start, torch.from_numpy(np.ascontiguousarray(blk, dtype=np_dtype)).to(dev)

    with full_f32_matmul():
        G = torch.zeros((d, d), dtype=acc, device=dev)
        s = torch.zeros(d, dtype=acc, device=dev)
        for _, b in _blocks(gram_np):
            G += (b.T @ b).to(acc)
            if zero_center:
                s += b.sum(dim=0, dtype=acc)
        G64 = G.double().cpu().numpy()
        s64 = s.double().cpu().numpy()

        if zero_center:
            mu = s64 / n
            G64 = G64 - n * np.outer(mu, mu)

        # the Gram matrix is tiny (features × features): a host float64 eigh
        evals, evecs = np.linalg.eigh(G64)  # ascending
        order = np.argsort(evals)[::-1][:n_comps]
        top_vals = np.maximum(evals[order], 0.0)
        V64 = evecs[:, order]  # (d, k)

        scores = np.empty((n, n_comps), dtype=acc_np)
        V_dev = torch.from_numpy(V64.astype(acc_np)).to(dev)
        mu_dev = torch.from_numpy((s64 / n).astype(acc_np)).to(dev) if zero_center else None
        for start, b in _blocks(acc_np):
            if zero_center:
                b = b - mu_dev
            scores[start : start + b.shape[0]] = (b @ V_dev).cpu().numpy()

    V_np = V64.astype(acc_np)
    if sign_convention:
        # deterministic signs: largest-|loading| entry of each component positive
        # (sklearn svd_flip-style; makes runs reproducible across backends)
        flip = np.sign(V_np[np.argmax(np.abs(V_np), axis=0), np.arange(n_comps)])
        flip[flip == 0] = 1.0
        scores *= flip
        V_np = V_np * flip

    return scores, V_np.T, np.sqrt(top_vals)
