"""The exact kNN stage's share of the H100's float32 peak outside the tensor cores, in %.

Operations: the program's counter ``knn_flops`` (2 x query rows x database
rows x features over the query blocks, ``ops/knn.py``); time: the spans
``neighbors.knn``, which hold the tiled products, the running top-k, the
database's copy to the card and the blocks' copies back.  A share of the
stage, not of one kernel: the products run in full float32 (TF32 off), so
the peak is ``hw.H100_F32_OPS_PER_S``, 67 TFLOP/s (NVIDIA's data sheet, SXM).
"""

from cnvbench import chain_spans, hw


def read(run):
    flops, seconds = chain_spans.counted(run, "knn_flops"), chain_spans.span_s(run, "neighbors.knn")
    if flops is None or not seconds:
        return None
    return 100.0 * flops / seconds / hw.H100_F32_OPS_PER_S
