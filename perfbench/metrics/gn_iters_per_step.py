"""``gn_iters_per_step``: the program's ``stefan.gn_iter`` spans (one
Gauss-Newton iteration of the marker Stefan solver each: the slab's
capacity rebuild, its solve, the LM update and the host reads) in the
profiled stretch, over its steps.  ``None`` without a trace or any such
span: a program without the span leaves nothing to read."""

from perfbench import spans


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    n = len(spans.intervals(tr, "stefan.gn_iter"))
    return n / tr["steps"] if n else None
