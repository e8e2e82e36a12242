"""Device-busy milliseconds per SRBD period (profiler trace, union of device
intervals over the traced periods)."""

from benchmark.harness import readers


def read(record):
    return readers.busy_ms_per_unit(record)
