"""``stats["host_pack_sec"]`` of one serialized ``_infercnv_compute(..., stats=...)`` call on the cell's devices."""


def read(run):
    return None if not run.stats or "host_pack_sec" not in run.stats else float(run.stats["host_pack_sec"])
