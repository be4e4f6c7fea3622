"""``idle_cg_pct``: the device's idle time inside the program's
``heat_fast.cg_chunk`` spans (the host issuing a CG chunk), as a share of
the profiled window, in percent.  A part of ``device_idle_pct``."""

from perfbench import spans


def read(rec):
    return spans.idle_pct(rec, "heat_fast.cg_chunk")
