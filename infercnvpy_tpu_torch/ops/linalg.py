"""Truncated SVD / PCA of the cell × window matrix (counterpart of ``infercnvpy_tpu/ops/linalg.py``).

Replaces the reference's ARPACK path (reference: tl/__init__.py:66-71 calls
``sc.tl.pca(svd_solver="arpack", zero_center=False)``): the (features ×
features) Gram matrix is accumulated on the device over row blocks (a sparse
input of any cell count is densified one block at a time), one float64
``eigh`` of that small matrix on the host gives the components, and the
scores are projected on the device block by block.  Each block's Gram
partial is summed into a float64 accumulator.  Given a list of devices,
each row block is split over them: every shard's partial goes into its
device's accumulator, the devices' sums are added in float64 on the host
once, and each device projects its rows (the JAX package's ``mesh`` branch,
``infercnvpy_tpu/ops/linalg.py:51-68, 125-230``).

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

from .._util import full_f32_matmul, pick_shards
from ..parallel.mesh import replicate, shard_rows

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
    products take ``dtype`` and sum in float32 within a block, the blocks'
    partials sum in float64, and the scores are float32;
    ``high_precision=True`` computes everything in float64.
    ``device=None`` is the CUDA device; a list of devices splits every row
    block over them, each device's sum added in float64 on the host.
    """
    devices = pick_shards(device, "truncated_svd")
    n, d = X.shape
    n_comps = int(min(n_comps, min(n, d)))
    # the Gram's products in ``dtype`` (float64 with high_precision), summed in float32 (float64) within a block
    acc_np = np.float64 if high_precision else np.float32
    acc = torch.float64 if high_precision else torch.float32
    gram_np = np.float64 if high_precision else np.dtype(dtype)

    def _blocks(np_dtype):
        """Each row block's shards, on their devices: ``(start, [tensor, ...])``."""
        for start in range(0, n, block_rows):
            blk = X[start : start + block_rows]
            blk = np.ascontiguousarray(blk.toarray() if sp.issparse(blk) else np.asarray(blk), dtype=np_dtype)
            ranges = shard_rows(blk.shape[0], len(devices))
            yield start, [torch.from_numpy(blk[lo:hi]).to(dev) for dev, (lo, hi) in zip(devices, ranges)]

    with full_f32_matmul():
        # each shard's partial in ``acc``, summed in float64 on its device; the devices' sums on the host
        G_acc = replicate(torch.zeros((d, d), dtype=torch.float64), devices)
        s_acc = replicate(torch.zeros(d, dtype=torch.float64), devices)
        for _, parts in _blocks(gram_np):
            for G, s, b in zip(G_acc, s_acc, parts):
                G += (b.T @ b).to(acc)
                if zero_center:
                    s += b.sum(dim=0, dtype=acc)
        G64 = sum(G.cpu().numpy() for G in {id(G): G for G in G_acc}.values())
        s64 = sum(s.cpu().numpy() for s in {id(s): s for s in s_acc}.values())

        if zero_center:
            mu = s64 / n
            G64 = G64 - n * np.outer(mu, mu)

        # the Gram matrix is tiny (features × features): a host float64 eigh
        evals, evecs = np.linalg.eigh(G64)  # ascending
        order = np.argsort(evals)[::-1][:n_comps]
        top_vals = np.maximum(evals[order], 0.0)
        V64 = evecs[:, order]  # (d, k)

        scores = np.empty((n, n_comps), dtype=acc_np)
        V_devs = replicate(torch.from_numpy(V64.astype(acc_np)), devices)
        mu_devs = replicate(torch.from_numpy((s64 / n).astype(acc_np)), devices) if zero_center else None
        for start, parts in _blocks(acc_np):
            projected = []
            for i, b in enumerate(parts):
                if zero_center:
                    b = b - mu_devs[i]
                projected.append(b @ V_devs[i])
            rows = sum(p.shape[0] for p in projected)
            scores[start : start + rows] = torch.cat([p.cpu() for p in projected]).numpy()

    V_np = V64.astype(acc_np)
    if sign_convention:
        # deterministic signs: largest-|loading| entry of each component positive
        # (sklearn svd_flip-style; makes runs reproducible across backends)
        flip = np.sign(V_np[np.argmax(np.abs(V_np), axis=0), np.arange(n_comps)])
        flip[flip == 0] = 1.0
        scores *= flip
        V_np = V_np * flip

    return scores, V_np.T, np.sqrt(top_vals)
