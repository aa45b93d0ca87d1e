"""The counter ``pinned_bytes`` (pinned host memory the call allocated: the upload slots and every growth of the
download buffers) summed over the spans, MiB a traced call."""

from cnvbench import spans


def read(run):
    mib = spans.counted("pinned_bytes")
    return None if mib is None else mib / 2**20
