"""``step_ms``: the window's wall time over all the steps it completed
(host clock over the whole window)."""


def read(rec):
    return rec["window_s"] * 1e3 / rec["steps"]
