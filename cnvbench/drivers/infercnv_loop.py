"""Closed loop of ``tl.infercnv`` calls, one caller, back to back, over the configuration's samples.

An atlas configuration holds one sample, called again and again; a cohort
holds a pool of samples, called one after another in an order drawn from the
seed.  Every call passes only the reference categories, so every other
parameter is the program's default.  A traffic file may add ``infercnv``
keyword arguments and a ``device`` (left out: the program's default, every
visible GPU; a list: that many cell shards, as the CPU tests run them).

Set-up makes the samples and warms up on the largest and the smallest.
After the window each distinct output of each sample is compared with the
plain reference (``reference/compare.py``).
"""

from __future__ import annotations

import numpy as np

from cnvbench import data, hw
from cnvbench.reference import compare as cmp
from cnvbench.reference.infercnv import Params, Reference, window_weights


class Driver:
    limits = cmp.LIMITS

    def __init__(self, cell, seed: int, device=None, log=print):
        self.cell = cell
        self.seed = int(seed)
        self.config = cell.config
        self.traffic = cell.traffic
        self.log = log
        self.on_cpu = device == "cpu"
        device_arg = self.traffic.get("device")
        if self.on_cpu:  # the CPU tests: as many shards as the traffic's device list, on the CPU
            device_arg = ["cpu"] * len(device_arg) if isinstance(device_arg, list) else "cpu"
        self.device_arg = device_arg
        self.n_devices = 0 if self.on_cpu else cell.chips
        self.outputs: list = []  # (sample index, X_cnv, chr_pos) of every call made
        # the reference takes the configuration's parameters and any the traffic passes the program
        names = Params.__dataclass_fields__
        given = {**self.config["infercnv"], **self.traffic.get("infercnv", {})}
        self.params = Params(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in given.items() if k in names})

    # -- set-up ---------------------------------------------------------------------------------------
    def setup(self) -> None:
        import torch

        gen_device = "cpu" if self.on_cpu else "cuda:0"
        self.var = data.make_var(int(self.config["genome"]["n_genes"]), int(self.config["genome"]["var_seed"]))
        self.sizes = data.sample_sizes(self.config)
        self.samples = [data.make_sample(self.config, self.var, n, self.seed, i, gen_device)
                        for i, n in enumerate(self.sizes)]
        self.adatas = [data.make_anndata(s, self.var) for s in self.samples]
        rng = np.random.default_rng(data.seed_state(self.seed, 3))
        self.order = rng.permutation(len(self.samples))
        if not self.on_cpu:
            torch.cuda.empty_cache()
        nnz = sum(s.X.nnz for s in self.samples)
        self.log(f"{len(self.samples)} samples, {sum(self.sizes):,} cells, nnz {nnz:,}")
        for i in dict.fromkeys([int(np.argmax(self.sizes)), int(np.argmin(self.sizes))]):
            self._infercnv(i)
        self.outputs.clear()

    def _infercnv(self, i: int, **extra):
        import infercnvpy_tpu_torch as tcnv

        adata = self.adatas[i]
        kw = dict(self.traffic.get("infercnv", {}), **extra)
        tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=self.samples[i].reference_cats,
                         device=self.device_arg, **kw)
        if not self.on_cpu:
            hw.synchronize(self.n_devices)
        return adata.obsm["X_cnv"], adata.uns["cnv"]["chr_pos"]

    # -- the window -----------------------------------------------------------------------------------
    def call(self, k: int) -> int:
        """The ``k``-th call of the loop; returns the cells it passed."""
        i = int(self.order[k % len(self.order)])
        x_cnv, chr_pos = self._infercnv(i)
        self.outputs.append((i, x_cnv, chr_pos))
        return self.sizes[i]

    # -- the trace run --------------------------------------------------------------------------------
    def stage_stats(self) -> dict:
        """The program's stage clock (``_infercnv_compute(stats=...)``, serialized) on the largest sample."""
        import torch

        from infercnvpy_tpu_torch._util import pick_devices
        from infercnvpy_tpu_torch.tl._infercnv import _get_reference, _infercnv_compute

        i = int(np.argmax(self.sizes))
        adata, p, keep = self.adatas[i], self.params, self._keep()
        reference = _get_reference(adata, "cell_type", self.samples[i].reference_cats, None, None)[:, keep]
        kw = dict(lfc_clip=p.lfc_clip, window_size=p.window_size, step=p.step, dynamic_threshold=p.dynamic_threshold,
                  chunksize=p.chunksize, batch_cells=None, dtype=None)
        kw.update({k: v for k, v in self.traffic.get("infercnv", {}).items() if k not in Params.__dataclass_fields__})
        stats: dict = {}
        chr_pos, x_cnv, _ = _infercnv_compute(
            adata.X[:, np.flatnonzero(keep)] if not keep.all() else adata.X,
            adata.var.loc[keep, ["chromosome", "start", "end"]], np.asarray(reference, dtype=np.float64),
            device=pick_devices(self.device_arg, "cnvbench"), stats=stats, progress=False, **kw,
        )
        if not self.on_cpu:
            torch.cuda.synchronize()
        self.outputs.append((i, x_cnv, chr_pos))
        return stats

    def shapes(self, calls: int) -> dict:
        """What the traced calls computed, from the configuration: cells, genes in windows, windows."""
        w = window_weights(self.var.loc[self._keep()], self.params.window_size, self.params.step)
        cells = sum(self.sizes[int(self.order[k % len(self.order)])] for k in range(calls))
        return {"cells": cells, "genes": w.n_genes_used, "windows": w.weights.shape[1],
                "window_size": self.params.window_size}

    def _keep(self) -> np.ndarray:
        """``tl.infercnv``'s gene mask: genes with a position, off the excluded chromosomes."""
        chrom = self.var["chromosome"]
        return (chrom.notnull() & ~chrom.isin(list(self.params.exclude_chromosomes))).to_numpy()

    # -- readings for the limits (calibrate.py) ---------------------------------------------------------
    def calibrate(self, control: bool = False) -> dict:
        """Worst readings of one call on each sample: the program's, or its control's (bfloat16 transfer)."""
        extra = {"transfer_dtype": "bfloat16"} if control else {}
        self.outputs = [(i, *self._infercnv(i, **extra)) for i in range(len(self.samples))]
        readings, _ = self.check()
        self.outputs.clear()
        return readings

    # -- after the window -----------------------------------------------------------------------------
    def release(self) -> None:
        """Drop the program's state (its results stay in ``outputs``)."""
        import infercnvpy_tpu_torch as tcnv

        for adata in self.adatas:
            adata.obsm.pop("X_cnv", None)
        tcnv.tl.clear_transform_caches()
        if not self.on_cpu:
            import torch

            torch.cuda.empty_cache()

    def check(self) -> tuple[dict, int]:
        """``(worst readings, calls whose output failed)`` over every distinct output of the window."""
        device = "cpu" if self.on_cpu else "cuda:0"
        groups: dict = {}
        for i, x_cnv, chr_pos in self.outputs:
            groups.setdefault((i, cmp.digest(x_cnv, chr_pos)), []).append((x_cnv, chr_pos))
        readings, failed = [], 0
        refs: dict = {}
        for (i, _), outs in sorted(groups.items(), key=lambda kv: kv[0][0]):
            if i not in refs:
                refs.clear()
                s = self.samples[i]
                refs[i] = Reference(s.X, self.var, s.labels, s.reference_cats, self.params, device)
            r = cmp.compare(*outs[0], refs[i])
            readings.append(r)
            failed += 0 if r.ok() else len(outs)
        nnz = sum(outs[0][0].nnz for outs in groups.values()) / sum(np.prod(outs[0][0].shape) for outs in groups.values())
        self.log(f"compared {len(groups)} distinct outputs of {len(self.outputs)} calls; X_cnv {nnz:.4%} nonzero")
        return cmp.worst(readings).as_dict(), failed
