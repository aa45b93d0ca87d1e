"""Median host seconds from each traced call's start (the ``cnvbench.call`` region) to its first CUDA runtime call
that starts device work or allocates for it (``tracefile.WORK_CALLS``)."""

import statistics

from cnvbench import tracefile


def read(run):
    if run.trace is None:
        return None
    ends = tracefile.preludes(run.trace)
    return statistics.median(ends) if ends else None
