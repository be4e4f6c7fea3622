"""``idle_slab_build_pct``: the device's idle time inside the program's
``stefan.slab_build`` spans (the slab's space-time band capacity rebuild),
as a share of the profiled window, in percent.  A part of
``device_idle_pct``."""

from perfbench import spans


def read(rec):
    return spans.idle_pct(rec, "stefan.slab_build")
