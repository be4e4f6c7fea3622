"""``gn_iter_ms``: mean duration of the program's ``stefan.gn_iter`` spans
in the profiled stretch, in ms: the host's time for one Gauss-Newton
iteration of the marker Stefan solver."""

from perfbench import spans


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    its = spans.intervals(tr, "stefan.gn_iter")
    if not its:
        return None
    return sum(e - s for s, e in its) / len(its) * 1e-6
