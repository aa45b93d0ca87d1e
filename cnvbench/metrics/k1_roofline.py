"""K1's (``csrc/fused_window.cu``) share of its roofline on an H100, in %.

Bytes and operations come from what the traced calls computed, not from how
K1 does it: each cell's genes that lie in a window read once (f32), its
windows and its sum, sum of squares and median written once (f32), and the
reference's two bound rows read once a launch; a pyramid-weighted window
costs ``2 * window_size`` operations.  Time is the summed device time of the
kernels named ``fused_window`` in the trace.
"""

from cnvbench.hw import bound

KERNEL = "fused_window"


def read(run):
    if run.trace is None or run.shapes is None:
        return None
    launches = [dur for name, _, dur in run.trace.kernels if KERNEL in name]
    if not launches:
        return None
    s = run.shapes
    n_bytes = 4 * (s["cells"] * (s["genes"] + s["windows"] + 3) + len(launches) * 2 * s["genes"])
    n_ops = s["cells"] * s["windows"] * 2 * s["window_size"]
    return 100.0 * bound(n_bytes, n_ops)["bound_ms"] / (sum(launches) / 1e3)
