"""The controller's own MPC-stage timer (CUDA events), mean over the MPC
ticks that a ``--trace 1`` run runs before the profiler starts [ms]."""

from benchmark.harness import readers


def read(record):
    return readers.mpc_solve_ms(record)
