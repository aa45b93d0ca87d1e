"""The spans ``infercnv.csr`` (host CSR assembly of each batch, pipelined), seconds a traced call."""

from cnvbench import spans


def read(run):
    return spans.stage_s("infercnv.csr")
