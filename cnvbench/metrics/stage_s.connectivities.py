"""The spans ``neighbors.connectivities``, seconds a traced chain: the fuzzy graph of pp.neighbors, umap-learn's sigma
search on the device and the fuzzy union on the host (ops/graph.py)."""

from cnvbench import chain_spans


def read(run):
    return chain_spans.span_s(run, "neighbors.connectivities")
