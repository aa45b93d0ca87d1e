"""Closed loop of infercnvpy's documented downstream chain on one atlas's ``X_cnv``, one caller, back to back.

Set-up makes the configuration's sample from the seed, runs ``tl.infercnv``
on it once with its defaults, untimed, and keeps ``X_cnv``, ``uns["cnv"]``
and ``obs["cell_type"]``; then one chain warms up.  Its graph alone is held
to the reference there, ``conn_err`` (a fraction of a second on the card):
a program whose graph reads over that limit computes another graph than
umap-learn's, on which Leiden does another amount of work, so set-up raises
and the run ends without a result rather than time another deployment.
Each call builds a fresh AnnData from those three and runs ``tl.pca`` →
``pp.neighbors`` → ``tl.leiden`` → ``tl.cnv_score`` → ``tl.umap`` with the
parameters of the configuration's ``downstream`` group (infercnvpy's
defaults; ``reference/downstream_compare.chain_of``) and ``device=None``,
the CUDA device; it passes the whole atlas.  After the window each distinct output is compared stage by
stage with the plain reference (``reference/downstream_compare.py``), which
decides ``correct``.
"""

from __future__ import annotations

import time

import numpy as np

from cnvbench import data
from cnvbench.reference import downstream as ref
from cnvbench.reference import downstream_compare as dcmp


class Driver:
    limits = dcmp.LIMITS

    def __init__(self, cell, seed: int, device=None, log=print):
        self.cell = cell
        self.seed = int(seed)
        self.config = cell.config
        self.chain = dcmp.chain_of(cell.config)  # each entry point's keyword arguments, the reference's too
        self.log = log
        self.on_cpu = device == "cpu"
        self.device_arg = "cpu" if self.on_cpu else None
        self.outputs: list = []  # the AnnData of every call made
        self.reference = None
        self.sound = None  # calibrate()'s chain, for the self-counting σ control

    # -- set-up ---------------------------------------------------------------------------------------
    def setup(self) -> None:
        import infercnvpy_tpu_torch as tcnv

        gen_device = "cpu" if self.on_cpu else "cuda:0"
        var = data.make_var(int(self.config["genome"]["n_genes"]), int(self.config["genome"]["var_seed"]))
        n = data.sample_sizes(self.config)[0]
        sample = data.make_sample(self.config, var, n, self.seed, 0, gen_device)
        adata = data.make_anndata(sample, var)
        tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=sample.reference_cats,
                         device=self.device_arg)
        self.x_cnv = adata.obsm["X_cnv"]
        self.cnv_uns = adata.uns["cnv"]
        self.obs = adata.obs[["cell_type"]].copy()
        del adata, sample
        self._free()
        self.log(f"X_cnv {self.x_cnv.shape[0]:,} x {self.x_cnv.shape[1]:,}, "
                 f"{self.x_cnv.nnz / np.prod(self.x_cnv.shape):.4%} nonzero")
        warm = dcmp.output_of(self._chain(self.x_cnv))
        t0 = time.perf_counter()
        err = dcmp.Reference(self.x_cnv, self.obs["cell_type"].to_numpy(), self._ref_device(),
                             self.chain).conn_err(warm)
        self._free()
        self.log(f"the warm-up chain's graph: conn_err {err!r} in {time.perf_counter() - t0:.3f}s")
        if err > self.limits["conn_err"]:
            raise RuntimeError(f"the warm-up chain's graph reads conn_err {err!r}, over its limit "
                               f"{self.limits['conn_err']!r}: the program computes another graph than umap-learn's, "
                               "so the window would time another deployment")

    def _free(self) -> None:
        if not self.on_cpu:
            import torch

            torch.cuda.empty_cache()

    def _chain(self, x_cnv):
        """One whole chain on a fresh AnnData holding ``x_cnv``; the AnnData."""
        import infercnvpy_tpu_torch as tcnv

        adata = tcnv.AnnData(obs=self.obs.copy(), obsm={"X_cnv": x_cnv}, uns={"cnv": dict(self.cnv_uns)})
        dev, chain = self.device_arg, self.chain
        tcnv.tl.pca(adata, **chain["pca"], device=dev)
        tcnv.pp.neighbors(adata, **chain["neighbors"], device=dev)
        tcnv.tl.leiden(adata, **chain["leiden"])
        tcnv.tl.cnv_score(adata, device=dev)
        tcnv.tl.umap(adata, **chain["umap"], device=dev)  # the layout back on the host: the device work has ended
        return adata

    # -- the window -----------------------------------------------------------------------------------
    def call(self, k: int) -> int:
        """The ``k``-th chain; returns the cells it passed."""
        self.outputs.append(self._chain(self.x_cnv))
        return self.x_cnv.shape[0]

    # -- the trace run --------------------------------------------------------------------------------
    def stage_stats(self) -> None:
        """No serialized stage clock: the chain's spans are the per-layer readings."""
        return None

    def shapes(self, calls: int) -> dict:
        n, d = self.x_cnv.shape
        return {"chains": calls, "cells": calls * n, "windows": d}

    # -- readings for the limits (calibrate.py) ---------------------------------------------------------
    def calibrate(self, control: bool = False) -> dict:
        """Readings of one chain: the program's; or its controls': the chain on ``X_cnv`` rounded through bfloat16
        (``bf16``), the JAX package's self-counting σ on the program's kNN (``self_sigma``), and the layout's
        readings for the program's own spectral start, the epochs skipped (``epochs_skipped``), for its layout
        permuted within its Leiden communities (``layout_within``) and for it permuted whole (``layout_global``)."""
        import torch

        from infercnvpy_tpu_torch.ops.umap_ import spectral_init

        if not control:
            self.sound = dcmp.output_of(self._chain(self.x_cnv))
            return self._reference().compare(self.sound)
        x16 = self.x_cnv.copy()
        x16.data = torch.from_numpy(np.ascontiguousarray(x16.data)).to(torch.bfloat16).float().numpy()
        sound = self.sound if self.sound is not None else dcmp.output_of(self._chain(self.x_cnv))
        reference = self._reference()
        rng = np.random.default_rng(self.seed)
        return {"bf16": reference.compare(dcmp.output_of(self._chain(x16))),
                "self_sigma": {"conn_err": reference.conn_err(sound, count_self=True)},
                "epochs_skipped": reference.layout_readings(sound, spectral_init(sound.connectivities)),
                "layout_within": reference.layout_readings(
                    sound, ref.shuffle_within(sound.layout, sound.labels, self.seed + 1)),
                "layout_global": reference.layout_readings(sound, rng.permutation(sound.layout))}

    # -- after the window -----------------------------------------------------------------------------
    def _reference(self) -> dcmp.Reference:
        if self.reference is None:
            self.reference = dcmp.Reference(self.x_cnv, self.obs["cell_type"].to_numpy(), self._ref_device(),
                                            self.chain)
        return self.reference

    def _ref_device(self) -> str:
        return "cpu" if self.on_cpu else "cuda:0"

    def release(self) -> None:
        """Drop the program's state (the chains' outputs stay in ``outputs``)."""
        self._free()

    def check(self) -> tuple[dict, int]:
        """``(worst readings, calls whose output failed)`` over every distinct output of the window."""
        groups: dict = {}
        for adata in self.outputs:
            out = dcmp.output_of(adata)
            groups.setdefault(dcmp.output_digest(out), []).append(out)
        readings, failed = [], 0
        for outs in groups.values():
            r = self._reference().compare(outs[0])
            readings.append(r)
            failed += 0 if dcmp.ok(r, self.limits) else len(outs)
        self.log(f"compared {len(groups)} distinct outputs of {len(self.outputs)} chains")
        return dcmp.worst(readings), failed
