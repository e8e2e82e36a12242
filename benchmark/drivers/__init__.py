"""One module per kind of system a configuration runs (its ``driver`` key)."""
