"""``idle_precond_pct``: the device's idle time inside the program's
``stokes.precond`` spans (one apply of the block-Schur preconditioner, the
host issuing its inner CG), as a share of the profiled window, in percent.
A part of ``device_idle_pct``."""

from perfbench import spans


def read(rec):
    return spans.idle_pct(rec, "stokes.precond")
