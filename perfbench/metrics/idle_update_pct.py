"""``idle_update_pct``: the device's idle time inside the program's
``stefan.update`` spans (the intercept Jacobian, the normal equations, the
LM step and the λ update), as a share of the profiled window, in percent.
A part of ``device_idle_pct``."""

from perfbench import spans


def read(rec):
    return spans.idle_pct(rec, "stefan.update")
