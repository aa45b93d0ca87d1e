"""The spans ``umap.epochs``, seconds a traced chain: the epochs of tl.umap on the device, to the layout's copy back."""

from cnvbench import chain_spans


def read(run):
    return chain_spans.span_s(run, "umap.epochs")
