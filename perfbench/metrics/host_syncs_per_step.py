"""``host_syncs_per_step``: calls that waited for the device in one episode
(``torch.cuda.set_sync_debug_mode``), over its steps."""


def read(rec):
    if rec["syncs"] is None:
        return None
    n, steps = rec["syncs"]
    return n / steps
