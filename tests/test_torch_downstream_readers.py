"""The benchmark's readers of the downstream chain's spans (``cnvbench/tests/test_cnvbench_downstream.py``), run here
too; the cell's whole runs stay there, since this suite loads JAX and a run refuses to report with JAX loaded."""

from cnvbench.tests.test_cnvbench_downstream import (  # noqa: F401
    test_chain_readers_say_nothing_without_spans,
    test_chain_stage_readers_by_hand,
    test_knn_roofline_and_idle_by_hand,
)
