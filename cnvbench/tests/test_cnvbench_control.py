"""On the card: the program passes the comparison and its control (bfloat16 transfer) fails it.

The atlas configuration at 10,240 cells (3 chunks) and its full 20,000 genes,
three seeds.  Skips where there is no CUDA device.
"""

from __future__ import annotations

import json

import pytest

from cnvbench import spec
from cnvbench.reference.compare import LIMITS


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
def test_program_passes_and_control_fails_on_the_card(seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    config = json.loads((spec.ROOT / "configs" / "atlas_102k.json").read_text())
    config["samples"] = {"count": 1, "cells_min": 10_240, "cells_max": 10_240}
    cell = spec.Cell(name="atlas_10k.windows", chips=1, config=config,
                     traffic={"driver": "infercnv_loop", "device": None, "infercnv": {}}, end_to_end=[], per_layer=[])
    driver = spec.driver("infercnv_loop").Driver(cell, seed, log=lambda msg: None)
    driver.setup()
    program = driver.calibrate()
    control = driver.calibrate(control=True)
    assert all(program[k] <= LIMITS[k] for k in LIMITS), program
    assert any(control[k] > LIMITS[k] for k in LIMITS), control
