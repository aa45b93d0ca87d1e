"""The comparison that decides ``correct`` for ``tl.infercnv``'s output against :class:`reference.infercnv.Reference`.

Numbers compared for each output (``X_cnv`` CSR and ``chr_pos``):

* ``value_err`` — the largest ``|program - reference|`` over the program's
  nonzero entries (the reference ungated, float64);
* ``gate_flip_share`` — the share of entries whose gate differs: the
  program kept the value and the reference's ``|x| >= threshold`` says drop,
  or the other way round;
* ``layout_mismatch`` — 1 where the shape or ``chr_pos`` differ, else 0.

Each has a limit of its own (:data:`LIMITS`), set between the largest
reading of sound runs over many seeds and the smallest reading of the
control, the program with its bfloat16 transfer path switched on (see
``PERF.md``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: number -> limit; a reading above its limit is not correct.  Set from the readings on an H100 (PERF.md):
#: sound runs (f32) at most 2.07e-7 / 1.15e-6 over 27 seeds of the three cells; the control
#: (bfloat16 transfer) at least 4.71e-4 / 3.67e-4 on the same seeds
LIMITS = {
    "value_err": 2e-5,
    "gate_flip_share": 3e-5,
    "layout_mismatch": 0,
}


@dataclass
class Readings:
    value_err: float = 0.0
    gate_flip_share: float = 0.0
    layout_mismatch: int = 0

    def as_dict(self) -> dict:
        return {"value_err": self.value_err, "gate_flip_share": self.gate_flip_share,
                "layout_mismatch": self.layout_mismatch}

    def ok(self, limits: dict = LIMITS) -> bool:
        return all(v <= limits[k] for k, v in self.as_dict().items())


def worst(readings) -> Readings:
    out = Readings()
    for r in readings:
        out.value_err = max(out.value_err, r.value_err)
        out.gate_flip_share = max(out.gate_flip_share, r.gate_flip_share)
        out.layout_mismatch = max(out.layout_mismatch, r.layout_mismatch)
    return out


def compare(x_cnv, chr_pos: dict, ref) -> Readings:
    """Readings of one program output against the reference ``ref`` of the same input."""
    import torch

    from .infercnv import dense_rows

    n = ref.X.shape[0]
    if tuple(x_cnv.shape) != (n, ref.n_windows) or dict(chr_pos) != ref.chr_pos:
        return Readings(value_err=float("inf"), gate_flip_share=1.0, layout_mismatch=1)
    x_cnv = x_cnv.tocsr()
    err, flips = 0.0, 0
    for lo, hi, x_res, thr in ref.chunks():
        got = dense_rows(x_cnv, lo, hi, ref.device, torch.float64)
        kept = got != 0
        if kept.any():
            err = max(err, float((got - x_res).abs()[kept].max()))
        keep_ref = x_res.abs() >= thr if thr is not None else x_res != 0
        flips += int((kept != keep_ref).sum())
        del got, kept, keep_ref, x_res
    return Readings(value_err=err, gate_flip_share=flips / (n * ref.n_windows), layout_mismatch=0)


def digest(x_cnv, chr_pos: dict) -> str:
    """Bytes of one output, to compare each distinct output once."""
    import hashlib

    h = hashlib.sha256(repr(sorted(chr_pos.items())).encode())
    x = x_cnv.tocsr()
    h.update(repr(x.shape).encode())
    for a in (x.indptr, x.indices, x.data):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()
