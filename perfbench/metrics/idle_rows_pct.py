"""``idle_rows_pct``: the device's idle time inside the program's
``navierstokes.picard_rows`` spans (one apply of the Picard rows in the
fgmres stepper, eager or replayed), as a share of the profiled window, in
percent.  A part of ``device_idle_pct``."""

from perfbench import spans


def read(rec):
    return spans.idle_pct(rec, "navierstokes.picard_rows")
