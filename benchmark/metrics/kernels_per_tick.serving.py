"""Device kernels per control tick (profiler trace, kernels started in the
window over its ticks)."""

from benchmark.harness import readers


def read(record):
    return readers.kernels_per_tick(record)
