"""From process start to the start of the window [s] (host clock)."""


def read(record):
    return record["setup_s"]
