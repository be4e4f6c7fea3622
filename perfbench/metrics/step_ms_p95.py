"""``step_ms_p95``: the 95th percentile, over all the window's intervals,
of interval time over the interval's steps.  Interval times are CUDA
events around each interval, so a 20-60 ms interval is read to the
microsecond."""

import statistics


def read(rec):
    per_step = [ms / rec["steps_per_interval"] for ms in rec["interval_ms"]]
    if len(per_step) < 20:
        return None
    return statistics.quantiles(per_step, n=20, method="inclusive")[18]
