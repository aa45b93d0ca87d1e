"""Self time of the span ``infercnv.subset`` (the gene subset ``adata[:, keep]``), seconds a traced call."""

from cnvbench import spans


def read(run):
    return spans.stage_s("infercnv.subset", self_time=True)
