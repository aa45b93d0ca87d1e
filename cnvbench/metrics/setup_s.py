"""Seconds from the harness's first statement to the first timed call: imports, data, kernels, warm-up."""


def read(run):
    return run.setup_s
