"""``gmres_iter_ms``: mean duration of the program's
``linsolve.fgmres_iter`` spans in the profiled stretch, in ms: the host's
time for one Arnoldi iteration (the preconditioner's apply, the operator's,
the Gram-Schmidt dots and the host read of the Hessenberg column)."""

from perfbench import spans


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    its = spans.intervals(tr, "linsolve.fgmres_iter")
    if not its:
        return None
    return sum(e - s for s, e in its) / len(its) * 1e-6
