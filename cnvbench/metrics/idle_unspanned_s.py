"""Seconds a traced call in which no device is busy (``Trace.all_busy``) and no non-root span of the program is
open on any thread: the host time that neither a device nor a stage span accounts for."""

from cnvbench import spans


def read(run):
    return spans.idle_unspanned_s(run.trace)
