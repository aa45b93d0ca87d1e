"""The spans ``umap.init``, seconds a traced chain: the spectral start of tl.umap, ARPACK on the host."""

from cnvbench import chain_spans


def read(run):
    return chain_spans.span_s(run, "umap.init")
