"""Resolve a cell of ``BENCHMARK.json`` to its files, by name.

A cell names a configuration and a traffic mix; the configuration's entry
names its file (``configs/<config>.json``), whose ``driver`` key names the
module that runs it (``drivers/<driver>.py``); the traffic mix is
``traffic/<traffic>.json``; every metric is a reader ``metrics/<metric>.py``
with ``read(record) -> float | None``; the correctness limits of a cell are
``limits/<cell>.json``. Adding a configuration, a mix, a metric or a cell
adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Metric(NamedTuple):
    name: str
    unit: str
    end_to_end: bool
    reader: ModuleType


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    driver: ModuleType
    end_to_end: List[Metric]  # reported with --trace 0
    per_layer: List[Metric]   # reported with --trace 1


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    """Import the Python file ``path`` (its name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"benchmark: {path} does not exist")
    spec = importlib.util.spec_from_file_location(name or f"bench_file_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"benchmark: {path} does not exist")
    return json.loads(path.read_text())


def _metrics(entries: List[dict], cell: str, end_to_end: bool, bench: Path) -> List[Metric]:
    out = []
    for m in entries:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        reader = load_module(bench / "metrics" / f"{m['name']}.py")
        out.append(Metric(m["name"], m["unit"], end_to_end, reader))
    return out


def resolve(cell_name: str, root: Path = ROOT) -> Cell:
    """The cell ``cell_name`` of ``root/BENCHMARK.json`` with its files."""
    manifest = read_json(root / "BENCHMARK.json")
    bench = root / manifest["paths"][0]
    cells: Dict[str, dict] = {w["name"]: w for w in manifest["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"benchmark: no workload {cell_name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    entry = cells[cell_name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = read_json(root / configs[entry["config"]]["file"])
    driver = load_module(bench / "drivers" / f"{config['driver']}.py",
                         f"benchmark.drivers.{config['driver']}")
    return Cell(
        name=cell_name, chips=int(entry["chips"]), config=config,
        traffic=read_json(bench / "traffic" / f"{entry['traffic']}.json"),
        limits=read_json(bench / "limits" / f"{cell_name}.json"), driver=driver,
        end_to_end=_metrics(manifest["end_to_end"], cell_name, True, bench),
        per_layer=_metrics(manifest["per_layer"], cell_name, False, bench),
    )
