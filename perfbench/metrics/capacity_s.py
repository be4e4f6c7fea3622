"""``capacity_s``: host seconds of the capacity build (``compute_capacity``
up to a device sync), part of ``setup_s``."""


def read(rec):
    return rec["capacity_s"]
