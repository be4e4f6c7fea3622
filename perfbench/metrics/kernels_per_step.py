"""``kernels_per_step``: device kernels (copies and fills left out) in the
profiled intervals, over their steps."""


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    n = sum(1 for ev in tr["device"]
            if not ev[0].startswith(("Memcpy", "Memset")))
    return n / tr["steps"] if n else None
