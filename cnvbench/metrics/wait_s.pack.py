"""The spans ``infercnv.wait`` with ``on="pack"`` (the main thread blocked on the packer thread), seconds a traced
call."""

from cnvbench import spans


def read(run):
    return spans.waits_s("pack")
