"""The comparison that decides ``correct``: gaps between what the timed
path produced and what the plain reference works out, each compared number
against its limit (``limits/<cell>.json``, set from measured readings: see
PERF.md).

An answer is one instance of one checked unit (a row of the batch); its gap
in a quantity is the largest absolute difference over the quantity's
elements. A compared number is a statistic of one quantity's gaps over
every checked answer, named ``<quantity>.<statistic>``:

* ``max``: the widest gap;
* ``share_gt_<T>``: the share of answers [%] whose gap exceeds T (the
  quantity's unit). Where a discrete decision of the solver (the QP
  polish's active set and acceptance) flips on rounding and moves an answer
  by a step, the widest gap measures the step, and this share counts how
  often it happens.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

THRESHOLDS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 5.0, 20.0)


def gap_rows(program, reference) -> torch.Tensor:
    """(rows,) float64 on the host: per row of the leading (batch) axis, the
    largest |program - reference|; inf for a row with a NaN, and every row
    inf where the shapes differ."""
    a = torch.as_tensor(program).detach().to(dtype=torch.float64)
    b = torch.as_tensor(reference).detach().to(dtype=torch.float64)
    a = a.to(b.device)
    rows = b.shape[0] if b.dim() else 1
    if a.shape != b.shape:
        return torch.full((rows,), math.inf, dtype=torch.float64)
    d = (a - b).abs().reshape(rows, -1)
    d = torch.where(torch.isnan(d), torch.full_like(d, math.inf), d)
    if d.shape[1] == 0:
        return torch.zeros(rows, dtype=torch.float64)
    return d.amax(dim=1).cpu()


def statistic(rows: torch.Tensor, kind: str) -> float:
    if rows.numel() == 0:
        return math.inf
    if kind == "max":
        return float(rows.max())
    if kind.startswith("share_gt_"):
        return 100.0 * float((rows > float(kind[len("share_gt_"):])).double().mean())
    raise KeyError(f"benchmark: unknown statistic {kind!r}")


class Gaps:
    """Every checked answer's gap, by quantity."""

    def __init__(self):
        self.rows: Dict[str, List[torch.Tensor]] = {}

    def add(self, name: str, program, reference) -> None:
        self.rows.setdefault(name, []).append(gap_rows(program, reference))

    def all(self, name: str) -> torch.Tensor:
        parts = self.rows.get(name, [])
        return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.float64)

    def answers(self) -> int:
        return max((int(self.all(n).numel()) for n in self.rows), default=0)

    def value(self, number: str) -> float:
        quantity, kind = number.split(".", 1)
        return statistic(self.all(quantity), kind)

    def readings(self) -> Dict[str, float]:
        """Every quantity's widest gap and its shares over THRESHOLDS."""
        out = {}
        for name in self.rows:
            rows = self.all(name)
            out[f"{name}.max"] = statistic(rows, "max")
            for t in THRESHOLDS:
                out[f"{name}.share_gt_{t:g}"] = statistic(rows, f"share_gt_{t:g}")
        return out


def judge(gaps: Gaps, limits: Dict[str, float]) -> Tuple[bool, List[dict]]:
    """(every compared number within its limit, rows {name, value, limit}).
    No limits, or a number the run did not read, fails."""
    rows = [{"name": name, "value": gaps.value(name), "limit": limit}
            for name, limit in limits.items()]
    return bool(rows) and all(r["value"] <= r["limit"] for r in rows), rows
