"""1 - device busy / wall over the traced ``tl.infercnv`` calls, the mean over the run's devices
(``tracefile.Trace``; a device the trace never shows busy counts as idle throughout)."""


def read(run):
    return None if run.trace is None else 100.0 * run.trace.idle_share()
