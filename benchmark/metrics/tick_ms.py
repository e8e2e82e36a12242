"""The window's seconds over the ticks completed in it [ms]: every tick, the
MPC ticks and the measurement read-back included (host clock)."""


def read(record):
    return 1e3 * record["window_s"] / record["units"]
