"""The spans ``neighbors.knn``, seconds a traced chain: the exact kNN of pp.neighbors, tiled products and a running
top-k on the device with the blocks' copies back (ops/knn.py)."""

from cnvbench import chain_spans


def read(run):
    return chain_spans.span_s(run, "neighbors.knn")
