"""``idle_slab_solve_pct``: the device's idle time inside the program's
``stefan.slab_solve`` spans (the reduced slab solve with its CG, and the
interface flux), as a share of the profiled window, in percent.  A part of
``device_idle_pct``."""

from perfbench import spans


def read(rec):
    return spans.idle_pct(rec, "stefan.slab_solve")
