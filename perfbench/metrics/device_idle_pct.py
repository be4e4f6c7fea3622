"""``device_idle_pct``: the share of the profiled window's wall span in
which no kernel, copy or fill ran on the device, in percent."""

from perfbench import trace


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["device"]:
        return None
    s0, s1 = tr["span"]
    busy = sum(e - s for s, e in trace.busy_intervals(tr["device"]))
    return 100.0 * (1.0 - busy / (s1 - s0))
