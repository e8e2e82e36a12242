"""The controller's own WBID-solve timer (CUDA events), mean over the ticks
that a ``--trace 1`` run runs before the profiler starts [ms]."""

from benchmark.harness import readers


def read(record):
    return readers.wbid_solve_ms(record)
