"""``stencil_launches_per_step``: launches of the stencil kernels in one
episode, by the wrappers' own ``launches`` counters, over its steps."""


def read(rec):
    if rec["launches"] is None:
        return None
    n, steps = rec["launches"]
    return n / steps
