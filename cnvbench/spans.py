"""The program's stage spans of a ``--trace 1`` run, reduced for the readers in ``metrics/``.

``infercnvpy_tpu_torch.profiling`` records the program's spans while
``profiling.trace`` runs and keeps those of the last capture, the traced calls,
in ``profiling.last_spans``: each with ``name``, ``thread``, ``start`` and
``end`` (the trace's microseconds), ``id``, ``parent`` (None for a root),
``call``, ``attrs`` and ``counts``.  Every value here is per call: the total
over the traced calls ÷ the number of ``infercnv`` root spans.  A program that
records no spans gives no reading (None), and raises nothing.
"""

from __future__ import annotations

from cnvbench import tracefile

ROOT = "infercnv"


def recorded() -> list | None:
    """The traced calls' spans, or None where the program recorded no ``infercnv`` root span."""
    from infercnvpy_tpu_torch import profiling

    found = getattr(profiling, "last_spans", None)
    return found if found and any(_is_root(s) for s in found) else None


def _is_root(s) -> bool:
    return s.parent is None and s.name == ROOT


def per_call(total) -> float | None:
    """``total(spans)`` over the traced calls' spans ÷ the number of calls; None without spans."""
    found = recorded()
    if found is None:
        return None
    return total(found) / sum(1 for s in found if _is_root(s))


def self_us(s, kids: dict) -> float:
    """``s``'s duration less what its children on its own thread cover; ``kids`` from :func:`children`."""
    mine = tracefile.union([(c.start, c.end) for c in kids.get(s.id, ()) if c.thread == s.thread])
    return (s.end - s.start) - tracefile.covered(mine, s.start, s.end)


def children(found: list) -> dict:
    """Span id -> its child spans."""
    out: dict = {}
    for s in found:
        if s.parent is not None:
            out.setdefault(s.parent, []).append(s)
    return out


def stage_s(name: str, self_time: bool = False, where=None) -> float | None:
    """Seconds a call in the spans ``name`` (those for which ``where(span)`` holds), their self time if asked."""

    def total(found):
        kids = children(found) if self_time else {}
        picked = [s for s in found if s.name == name and (where is None or where(s))]
        return sum(self_us(s, kids) if self_time else s.end - s.start for s in picked) / 1e6

    return per_call(total)


def waits_s(*on: str) -> float | None:
    """Seconds a call that threads blocked in ``infercnv.wait`` spans for any of ``on``."""
    return stage_s("infercnv.wait", where=lambda s: s.attrs.get("on") in on)


def counted(counter: str) -> float | None:
    """The counter ``counter`` summed over every span, a call."""
    return per_call(lambda found: float(sum(s.counts.get(counter, 0) for s in found)))


def idle_unspanned_s(trace) -> float | None:
    """Seconds a call of the traced window in which no device is busy and no non-root span is open."""
    if trace is None:
        return None

    def total(found):
        lo, hi = trace.window
        spanned = [(s.start, s.end) for s in found if s.parent is not None]
        cover = tracefile.union([tuple(iv) for iv in trace.all_busy()] + spanned)
        return ((hi - lo) - tracefile.covered(cover, lo, hi)) / 1e6

    return per_call(total)
