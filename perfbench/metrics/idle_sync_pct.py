"""``idle_sync_pct``: the device's idle time inside the program's
``heat_fast.cg_flag`` spans (a CG chunk's one host read of its flag), as a
share of the profiled window, in percent.  A part of ``device_idle_pct``,
apart from ``idle_cg_pct``; ``idle_sync_pct.3d`` is the same quantity."""

from perfbench import spans


def read(rec):
    return spans.idle_pct(rec, "heat_fast.cg_flag")
