"""Device kernels per control tick of the sweep (profiler trace, kernels
started in the window over its periods x ticks a period)."""

from benchmark.harness import readers


def read(record):
    return readers.kernels_per_tick(record)
