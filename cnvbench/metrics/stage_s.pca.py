"""The spans ``pca``, seconds a traced chain: tl.pca, the Gram on the device, its eigendecomposition on the host and
the projection."""

from cnvbench import chain_spans


def read(run):
    return chain_spans.span_s(run, "pca")
