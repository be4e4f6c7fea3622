"""``cg_graph_share``: the share of the program's ``heat_fast.cg_chunk``
spans in the profiled stretch that hold a ``heat_fast.cg_graph`` span (the
chunk replayed as a CUDA graph), in percent; ``cg_graph_share.3d`` is the
same quantity.  ``None`` without a trace, a chunk, or any graph span: a
program that never replays a chunk leaves nothing to read."""

import bisect

from perfbench import spans


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    chunks = spans.intervals(tr, "heat_fast.cg_chunk")
    starts = [s for s, _ in spans.intervals(tr, "heat_fast.cg_graph")]
    if not chunks or not starts:
        return None
    held = 0
    for s, e in chunks:
        i = bisect.bisect_left(starts, s)
        held += i < len(starts) and starts[i] < e
    return 100.0 * held / len(chunks)
