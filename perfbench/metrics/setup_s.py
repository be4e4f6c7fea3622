"""``setup_s``: seconds from the start of the process to the end of the
warm-up episode, on the host clock."""


def read(rec):
    return rec["setup_s"]
