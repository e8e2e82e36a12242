"""MPC solves completed per second: batch x SRBD periods (one solve per
instance each) over the window from its start to the end of its last
period (host clock)."""


def read(record):
    return record["batch"] * record["units"] / record["window_s"]
