"""Cells passed through ``tl.infercnv`` / the whole window (first call's start to last call's end), whole calls only."""


def read(run):
    if not run.calls:
        return None
    return sum(n for _, _, n in run.calls) / (run.calls[-1][1] - run.calls[0][0])
