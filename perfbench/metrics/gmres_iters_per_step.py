"""``gmres_iters_per_step``: the program's ``linsolve.fgmres_iter`` spans
(one Arnoldi iteration of flexible GMRES each, its host read included) in
the profiled stretch, over its steps.  ``None`` without a trace or any such
span: a program without the span leaves nothing to read."""

from perfbench import spans


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    n = len(spans.intervals(tr, "linsolve.fgmres_iter"))
    return n / tr["steps"] if n else None
