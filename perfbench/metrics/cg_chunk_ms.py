"""``cg_chunk_ms``: mean duration of the program's ``heat_fast.cg_chunk``
spans in the profiled stretch, in ms: the host's time to launch one chunk
of ``CG_CHUNK`` iterations, its flag read left out."""

from perfbench import spans


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    chunks = spans.intervals(tr, "heat_fast.cg_chunk")
    if not chunks:
        return None
    return sum(e - s for s, e in chunks) / len(chunks) * 1e-6
