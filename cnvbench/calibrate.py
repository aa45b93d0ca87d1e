"""Readings of the numbers compared, for the program and for its control, over many seeds in one process.

    python3 -m cnvbench.calibrate --workload atlas_102k.windows --seeds 1,2,3

For each seed: the cell's set-up, one program call on each sample, the
comparison; then the control on the same samples, the comparison again.  The
control is the program with its lower-precision path switched on
(``tl.infercnv(transfer_dtype="bfloat16")``).  Prints one JSON line per
seed; the limits in ``reference/compare.py`` are set from these readings
(``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from cnvbench import hw, run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cnvbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control", type=int, default=1, help="also read the control (1) or not (0)")
    args = ap.parse_args(argv)
    root = Path.cwd()
    cell = spec.cell(spec.load_benchmark(root), args.workload, root)
    hw.limit_visible(cell.chips)
    hw.require_cuda(cell.chips)
    run.log(f"card: {hw.power_line()}")
    mod = spec.driver(cell.traffic["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        driver = mod.Driver(cell, seed, log=run.log)
        driver.setup()
        line = {"workload": args.workload, "seed": seed, "program": driver.calibrate()}
        if args.control:
            line["control"] = driver.calibrate(control=True)
        print(json.dumps(line), flush=True)
        driver.release()
        del driver
    return 0


if __name__ == "__main__":
    sys.exit(main())
