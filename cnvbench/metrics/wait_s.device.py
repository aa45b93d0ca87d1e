"""The spans ``infercnv.wait`` with ``on`` ``copies`` or ``compute`` (a thread blocked on the copy streams or on
the counts' readback after the compute), seconds a traced call."""

from cnvbench import spans


def read(run):
    return spans.waits_s("copies", "compute")
