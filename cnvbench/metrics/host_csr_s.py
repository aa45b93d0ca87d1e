"""``stats["csr_sec"]`` of one serialized ``_infercnv_compute(..., stats=...)`` call: host CSR assembly (serialized)."""


def read(run):
    return None if not run.stats or "csr_sec" not in run.stats else float(run.stats["csr_sec"])
