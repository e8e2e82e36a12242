"""Metrics registry: latency percentiles and throughput counters.

Port of ``g1_locomotion_tpu/utils/stats.py`` (the analogue of the original
controller's pal_statistics registries, ``/wbid_statistics`` and
``/mpc_statistics``). Timing happens on the host around a call; PyTorch
returns before the card finishes, so :meth:`Timer.time` waits for the card
of every tensor the call returns (``torch.cuda.synchronize``, where the
reference calls ``block_until_ready``). The statistics are plain numpy:
nothing on the hot path.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np
import torch

from g1_locomotion_tpu_torch.utils import tree


def synchronize(out) -> None:
    """Wait for every card that holds a tensor of ``out`` (a nested tree)."""
    for device in {x.device for x in tree.leaves(out)
                   if isinstance(x, torch.Tensor) and x.device.type == "cuda"}:
        torch.cuda.synchronize(device)


@dataclass
class Timer:
    """Collects wall-clock samples for one named operation."""

    name: str
    samples_ms: List[float] = field(default_factory=list)

    def time(self, fn: Callable, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(out)
        self.samples_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def summary(self) -> Dict[str, float]:
        s = np.asarray(self.samples_ms)
        if s.size == 0:
            return {"name": self.name, "n": 0}
        return {
            "name": self.name,
            "n": int(s.size),
            "mean_ms": float(s.mean()),
            "p50_ms": float(np.percentile(s, 50)),
            "p99_ms": float(np.percentile(s, 99)),
            "min_ms": float(s.min()),
            "max_ms": float(s.max()),
        }


@dataclass
class StatisticsRegistry:
    """Named scalars and timers, exportable as JSON: the pal_statistics
    analogue (ros_run_simulation.py:509-511)."""

    topic: str
    timers: Dict[str, Timer] = field(default_factory=dict)
    scalars: Dict[str, float] = field(default_factory=dict)

    def timer(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    def set(self, name: str, value: float) -> None:
        self.scalars[name] = float(value)

    def export(self) -> str:
        return json.dumps(
            {
                "topic": self.topic,
                "scalars": self.scalars,
                "timers": [t.summary() for t in self.timers.values()],
            }
        )


def throughput(batch: int, seconds: float) -> float:
    return batch / seconds if seconds > 0 else float("inf")
