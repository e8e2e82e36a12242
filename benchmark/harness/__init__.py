"""The yardstick: cell resolution, traffic, windows, traces, work counts and
the comparison with the plain reference. Nothing here imports the program."""
