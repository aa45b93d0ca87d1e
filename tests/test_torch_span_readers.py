"""The benchmark's readers of the program's stage spans (``cnvbench/tests/test_cnvbench_spans.py``), run here too."""

from cnvbench.tests.test_cnvbench_spans import *  # noqa: F401,F403
