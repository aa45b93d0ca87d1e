"""90th percentile of the wall of every call in the window (the result line's ``attempted`` counts them)."""

import statistics


def read(run):
    walls = [b - a for a, b, _ in run.calls]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
