"""The benchmark of ``infercnvpy_tpu_torch`` on NVIDIA GPUs.

One command runs one cell of ``BENCHMARK.json`` once, in a fresh process::

    python3 -m cnvbench.run --workload atlas_102k.windows --seed 7 --seconds 30 --trace 0

A cell is a configuration (``configs/<name>.json``: the data a deployment
holds) under a traffic mix (``traffic/<name>.json``: which driver runs it and
with which arguments).  Drivers (``drivers/<name>.py``) and metric readers
(``metrics/<name>.py``) are found by name, so a new cell, mix or metric is
new files and new entries in ``BENCHMARK.json``, never an edit.

The yardstick lives here and not in the program: the data generator, the
plain reference (``reference/``), the comparison that decides ``correct``,
the trace reduction and the H100's peaks.  The benchmark imports neither JAX
nor the JAX package ``infercnvpy_tpu``, and checks that the program did not
either.
"""
