"""100 minus the device's busy share of the traced window [%]: whole sweep
periods (profiler trace, union of device intervals)."""

from benchmark.harness import readers


def read(record):
    return readers.idle_pct(record)
