"""Self time of the spans ``infercnv.pack`` on any thread (the host pack of each batch, less its waits for the
slot's previous copies), seconds a traced call."""

from cnvbench import spans


def read(run):
    return spans.stage_s("infercnv.pack", self_time=True)
