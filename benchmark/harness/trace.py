"""Read a ``torch.profiler`` trace kept in memory: device intervals, the
benchmark's own spans and the host's operations.

The kernel names are the program's; ``kernel_id`` and ``op_kind`` are
copies of ``chip_smoke.py``'s. The busy time is the union of the device
intervals (kernels, copies, fills) inside the traced window, as
``chip_smoke.profile_path`` computes it. Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"


class Trace(NamedTuple):
    device: List[Tuple[int, int, str]]   # (start ns, end ns, name), by start
    host_ops: List[Tuple[int, int, str]]  # the host's operations, by start
    spans: List[Tuple[int, int, str]]     # the benchmark's spans, by start
    window: Tuple[int, int]               # the traced window (ns)


def kernel_id(device_kernel_name: str) -> str:
    """B1-B4 for the port's own kernels (plain or mangled name), else 'other ops'."""
    for mark, key in (("gj_tile_kernel<true", "B3"), ("gj_tile_kernelILb1", "B3"),
                      ("gj_tile_kernel<false", "B2"), ("gj_tile_kernelILb0", "B2"),
                      ("gj_cluster_kernel", "B3"),
                      ("gj_smem_kernel", "B2/B3 shared-memory kernel"),
                      ("admm_tile_kernel", "B4"), ("admm_smem_kernel", "B4 shared-memory kernel"),
                      ("chol_inv_base_kernel", "B1")):
        if mark in device_kernel_name:
            return key
    return "other ops"


def op_kind(device_kernel_name: str) -> str:
    """A coarse kind for a device operation's name: the port's own kernels
    by id, cuBLAS products, `torch.cat`, copies, fills, everything else."""
    kind = kernel_id(device_kernel_name)
    if kind != "other ops":
        return kind
    low = device_kernel_name.lower()
    for kind, marks in (("cuBLAS", ("gemm", "gemv", "cutlass", "cublas")),
                        ("cat", ("catarray",)), ("copy", ("copy", "memcpy")),
                        ("fill", ("memset", "fill"))):
        if any(mark in low for mark in marks):
            return kind
    return "other elementwise / reduction"


def is_kernel(name: str) -> bool:
    """A launched kernel, not a copy or a fill issued by the runtime."""
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def _times(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        start = int(e.start_ns())
        return start, start + int(e.duration_ns())
    start = int(e.start_us()) * 1000
    return start, start + int(e.duration_us()) * 1000


def capture(fn: Callable[[], None]) -> Tuple[Trace, float]:
    """Run ``fn`` under the profiler inside the span ``bench.window`` (fn
    ends with the device idle): (its trace, the window's host seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW_SPAN):
            fn()
        host_s = time.perf_counter() - t0
    results = prof.profiler.kineto_results
    device, host_ops, spans = [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in results.events():
        name = e.name()
        start, end = _times(e)
        if e.device_type() == cuda:
            if not name.startswith(SPAN_PREFIX) and not e.is_user_annotation():
                device.append((start, end, name))
        elif name.startswith(SPAN_PREFIX):
            spans.append((start, end, name))
        else:
            host_ops.append((start, end, name))
    device.sort()
    host_ops.sort()
    spans.sort()
    window = next(((s, e) for s, e, n in spans if n == WINDOW_SPAN), None)
    if window is None:
        raise RuntimeError("benchmark: the profiler recorded no bench.window span")
    return Trace(device, host_ops, [s for s in spans if s[2] != WINDOW_SPAN], window), host_s


def _clipped(trace: Trace) -> List[Tuple[int, int, str]]:
    lo, hi = trace.window
    return [(max(s, lo), min(e, hi), n) for s, e, n in trace.device if e > lo and s < hi]


def merged(intervals: List[Tuple[int, int, str]]) -> List[Tuple[int, int]]:
    """The union of (start, end, ...) intervals sorted by start, as disjoint
    (start, end) pairs."""
    out: List[List[int]] = []
    for s, e, *_ in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    """Seconds inside the window in which some operation ran on the device."""
    return sum(e - s for s, e in merged(_clipped(trace))) / 1e9


def window_s(trace: Trace) -> float:
    return (trace.window[1] - trace.window[0]) / 1e9


def kernel_count(trace: Trace) -> int:
    """Kernels (not copies or fills) that started inside the window."""
    lo, hi = trace.window
    return sum(1 for s, _, n in trace.device if lo <= s < hi and is_kernel(n))


def device_s_by(trace: Trace, key: Callable[[str], str]) -> Dict[str, float]:
    """Device seconds inside the window, summed by key(name)."""
    out: Dict[str, float] = {}
    for s, e, n in _clipped(trace):
        k = key(n)
        out[k] = out.get(k, 0.0) + (e - s) / 1e9
    return out


def _innermost(ops_start: np.ndarray, ops: List[Tuple[int, int, str]], t: int) -> str:
    """The name of the latest-started host operation that contains t."""
    i = int(np.searchsorted(ops_start, t, side="right")) - 1
    for j in range(i, max(i - 256, -1), -1):
        if ops[j][1] >= t:
            return ops[j][2]
    return "(no host op)"


def idle_gaps(trace: Trace, top: int = 10, examined: int = 4000) -> List[List]:
    """The device's idle time inside the window by what the host was doing
    then: of the ``examined`` longest gaps between device intervals, the
    seconds summed by (the benchmark's span, the innermost host operation)
    at each gap's middle, the ``top`` largest."""
    lo, hi = trace.window
    busy = merged(_clipped(trace))
    edges = [lo] + [x for pair in busy for x in pair] + [hi]
    gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    ops_start = np.array([s for s, _, _ in trace.host_ops], dtype=np.int64)
    span_starts = [s for s, _, _ in trace.spans]
    out: Dict[str, float] = {}
    for length, start in gaps[:examined]:
        mid = start + length // 2
        k = bisect.bisect_right(span_starts, mid) - 1
        span = "(outside the benchmark's spans)"
        while k >= 0:
            if trace.spans[k][1] >= mid:
                span = trace.spans[k][2][len(SPAN_PREFIX):]
                break
            k -= 1
        op = _innermost(ops_start, trace.host_ops, mid) if len(ops_start) else "(no host op)"
        key = f"{span}: {op}"
        out[key] = out.get(key, 0.0) + length / 1e9
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(trace: Trace, top: int = 10) -> List[List]:
    """Device seconds inside the window by op_kind, the ``top`` largest."""
    by = device_s_by(trace, op_kind)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
