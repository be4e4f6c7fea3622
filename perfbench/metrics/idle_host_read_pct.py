"""``idle_host_read_pct``: the device's idle time inside the program's
``linsolve.fgmres_host`` spans (an Arnoldi iteration's host read of its
Hessenberg column and the Givens update on the host), as a share of the
profiled window, in percent.  A part of ``device_idle_pct``, apart from
``idle_precond_pct``."""

from perfbench import spans


def read(rec):
    return spans.idle_pct(rec, "linsolve.fgmres_host")
