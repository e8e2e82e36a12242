"""Scenario-ticks completed per second: batch x ticks a period x whole
periods, over the window from its start to the end of its last period
(host clock)."""


def read(record):
    return record["batch"] * record["ticks_per_unit"] * record["units"] / record["window_s"]
