"""What the per-layer metrics read from a traced run's record. Each returns
None where the record holds nothing to read, and the metric is then left out
of the result line."""

from __future__ import annotations

from typing import Optional

from benchmark.harness import trace as tr
from benchmark.harness import work


def _trace(record):
    return record.get("trace")


def idle_pct(record) -> Optional[float]:
    trace = _trace(record)
    if trace is None or not trace.device:
        return None
    return 100.0 * (1.0 - tr.busy_s(trace) / tr.window_s(trace))


def busy_ms_per_unit(record) -> Optional[float]:
    trace = _trace(record)
    if trace is None or not trace.device or not record["units"]:
        return None
    return 1e3 * tr.busy_s(trace) / record["units"]


def kernels_per_tick(record) -> Optional[float]:
    trace = _trace(record)
    if trace is None or not trace.device:
        return None
    return tr.kernel_count(trace) / (record["units"] * record["ticks_per_unit"])


def _stage_mean(record, name: str) -> Optional[float]:
    samples = record.get("program", {}).get("stage_ms", {}).get(name, [])
    if not samples:
        return None
    return sum(samples) / len(samples)


def mpc_solve_ms(record) -> Optional[float]:
    return _stage_mean(record, "mpc_solve")


def wbid_solve_ms(record) -> Optional[float]:
    return _stage_mean(record, "wbid_solve")


def b1_roofline_pct(record) -> Optional[float]:
    """Where the trace holds as many B1 kernels as the window launched."""
    trace, launches = _trace(record), record.get("b1_launches", [])
    if trace is None or not launches:
        return None
    lo, hi = trace.window
    spans = [(s, e) for s, e, n in trace.device
             if lo <= s < hi and tr.kernel_id(n) == "B1"]
    if len(spans) != len(launches):
        return None
    measured = sum(e - s for s, e in spans) / 1e9
    bound = sum(work.b1_bound_s(b, n, dtype) for b, n, dtype in launches)
    return 100.0 * bound / measured
