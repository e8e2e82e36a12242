"""B1's share of its roofline [%]: the least time the card needs for every
B1 launch of the traced window (bytes over bandwidth or operations over
the vector rate, from each launch's shape) over the device time of its
kernel chol_inv_base_kernel in the trace."""

from benchmark.harness import readers


def read(record):
    return readers.b1_roofline_pct(record)
