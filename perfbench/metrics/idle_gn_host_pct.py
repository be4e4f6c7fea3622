"""``idle_gn_host_pct``: the device's idle time inside the program's
``stefan.gn_host`` spans (a GN iteration's host reads: its Krylov count and
its stop test), as a share of the profiled window, in percent.  A part of
``device_idle_pct``."""

from perfbench import spans


def read(rec):
    return spans.idle_pct(rec, "stefan.gn_host")
