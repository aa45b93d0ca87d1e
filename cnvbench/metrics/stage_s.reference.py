"""The span ``infercnv.reference`` (the reference means, ``_get_reference``), seconds a traced call."""

from cnvbench import spans


def read(run):
    return spans.stage_s("infercnv.reference")
