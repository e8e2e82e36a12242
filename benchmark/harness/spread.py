"""The spread of a metric over a set of runs, as the bounds are set from it:
the distance between the first and third quartiles as Python's
``statistics.quantiles(values, n=4)`` gives them, over the median."""

from __future__ import annotations

import statistics
from typing import Sequence


def spread(values: Sequence[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
