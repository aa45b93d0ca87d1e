"""The span ``infercnv.setup`` with its child ``infercnv.slots`` (dtype, checkpoint, LUT, transform, reference
pack and replicate, the pinned slots), seconds a traced call."""

from cnvbench import spans


def read(run):
    return spans.stage_s("infercnv.setup")
