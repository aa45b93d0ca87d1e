"""The spans ``leiden``, seconds a traced chain: tl.leiden, native/leiden.cpp on one host thread and the labels'
categories."""

from cnvbench import chain_spans


def read(run):
    return chain_spans.span_s(run, "leiden")
