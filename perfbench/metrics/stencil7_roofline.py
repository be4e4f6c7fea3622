"""``stencil7_roofline``: the least time of one ``stencil7_kernel`` launch
(its bytes at the card's HBM bandwidth: bytes bind) over its mean device
time in the profiled intervals, in percent."""

from perfbench import roofline


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    times = [e - s for name, s, e, *_ in tr["device"]
             if "stencil7_kernel" in name]
    least = roofline.least_seconds(rec["device_kind"], 3, rec["numel"],
                                   rec["itemsize"])
    if not times or least is None:
        return None
    return 100.0 * least / (sum(times) / len(times) * 1e-9)
