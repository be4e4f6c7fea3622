"""``stencil5_us``: mean device time of one ``stencil5_kernel`` launch in
the profiled intervals, in microseconds.  A time and not a roofline share:
inside the CG loop the 2D operator's arrays stay in the card's L2, so a
share of the HBM bound would read above 100%."""


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    times = [e - s for name, s, e, *_ in tr["device"]
             if "stencil5_kernel" in name]
    return sum(times) / len(times) * 1e-3 if times else None
