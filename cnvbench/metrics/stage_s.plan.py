"""The span ``infercnv.plan`` (``build_window_plan``), seconds a traced call."""

from cnvbench import spans


def read(run):
    return spans.stage_s("infercnv.plan")
