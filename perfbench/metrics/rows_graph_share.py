"""``rows_graph_share``: the share of the program's
``navierstokes.picard_rows`` spans (one apply of the Picard rows in the
fgmres stepper) in the profiled stretch that hold a
``navierstokes.picard_rows_graph`` span (the apply replayed as a CUDA
graph), in percent.  ``None`` without a trace, an apply, or any graph span:
a program that never replays the rows leaves nothing to read."""

import bisect

from perfbench import spans


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    applies = spans.intervals(tr, "navierstokes.picard_rows")
    starts = [s for s, _ in spans.intervals(
        tr, "navierstokes.picard_rows_graph")]
    if not applies or not starts:
        return None
    held = 0
    for s, e in applies:
        i = bisect.bisect_left(starts, s)
        held += i < len(starts) and starts[i] < e
    return 100.0 * held / len(applies)
