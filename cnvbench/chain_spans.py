"""The downstream chain's spans of a ``--trace 1`` run, reduced for the readers in ``metrics/``.

``spans.py`` divides by the ``infercnv`` root spans, of which a chain has
none; here every value is per traced chain: the total over the traced calls
÷ the number of traced calls (the trace's ``cnvbench.call`` regions).  The
chain's spans are ``pca``, ``neighbors`` (children ``neighbors.knn``, counter
``knn_flops``, and ``neighbors.connectivities``), ``leiden`` (counter
``leiden_communities``), ``cnv_score`` and ``umap`` (children ``umap.init``
and ``umap.epochs``, counter ``umap_edges``).  A program that records none of
the spans or counters asked for gives no reading (None), and raises nothing.
"""

from __future__ import annotations


def _spans(run) -> list:
    from infercnvpy_tpu_torch import profiling

    return list(getattr(profiling, "last_spans", None) or []) if run.trace is not None else []


def span_s(run, name: str) -> float | None:
    """Seconds a traced chain in the spans ``name``; None where there are none."""
    picked = [s for s in _spans(run) if s.name == name]
    if not picked:
        return None
    return sum(s.end - s.start for s in picked) / 1e6 / len(run.trace.calls)


def counted(run, counter: str) -> float | None:
    """The counter ``counter`` summed over every span, a traced chain; None where no span counted it."""
    found = [s.counts[counter] for s in _spans(run) if counter in s.counts]
    if not found:
        return None
    return float(sum(found)) / len(run.trace.calls)
