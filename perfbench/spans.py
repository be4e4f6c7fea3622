"""The program's spans in a traced run: the host events that
``penguin_tpu_torch.diagnostics.span`` leaves in the profiled stretch, on
the clock of its device events, and the device's idle time inside them.

A span is a host event of exactly its name.  The device is idle where no
kernel, copy or fill runs: the complement of ``trace.busy_intervals``.
Idle time is measured by overlap, not by a gap's midpoint, so a gap that
straddles a span's edge counts only its part inside the span.
"""

from __future__ import annotations

from perfbench import trace

__all__ = ["intervals", "idle_pct"]


def intervals(tr, name):
    """The spans named ``name`` in trace ``tr``, clipped to its profiled
    window, as sorted ``(start, end)`` pairs in ns."""
    s0, s1 = tr["span"]
    clipped = ((max(s, s0), min(e, s1)) for n, s, e, *_ in tr["host"]
               if n == name)
    return sorted((s, e) for s, e in clipped if e > s)


def _overlap(a, b):
    """Total length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct(rec, name):
    """100 × the device's idle time inside the spans named ``name``, over
    the profiled window; ``None`` without a trace, device events or such a
    span."""
    tr = rec["trace"]
    if not tr or not tr["device"]:
        return None
    inside = trace.busy_intervals([(name, s, e)
                                   for s, e in intervals(tr, name)])
    if not inside:
        return None
    s0, s1 = tr["span"]
    busy = _overlap(inside, trace.busy_intervals(tr["device"]))
    return 100.0 * (sum(e - s for s, e in inside) - busy) / (s1 - s0)
