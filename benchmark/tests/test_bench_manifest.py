"""BENCHMARK.json resolves every cell to its files by name, and a new
configuration, traffic mix, metric and cell are added as files and entries
alone."""

import json
import shutil
from pathlib import Path

import pytest

from benchmark.harness import manifest

ROOT = Path(__file__).resolve().parents[2]


def test_every_cell_resolves():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in data["workloads"]:
        cell = manifest.resolve(w["name"], ROOT)
        assert cell.config["name"] == w["config"]
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m.name for m in cell.end_to_end}
        assert cell.limits, f"{w['name']} has no correctness limits"
        assert hasattr(cell.driver, "DRIVER")


def test_contract_shape():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [m["name"] for m in data["end_to_end"] + data["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in data["end_to_end"]}
    for m in data["per_layer"]:
        assert m["moves"] in e2e
    for c in data["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def test_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a metric and a
    cell: new files and new entries, no existing file edited."""
    root = tmp_path / "checkout"
    (root / "benchmark").mkdir(parents=True)
    for name in ("configs", "traffic", "metrics", "limits", "drivers", "harness"):
        shutil.copytree(ROOT / "benchmark" / name, root / "benchmark" / name)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/g1_srbd_gait_sweep.json").read_text())
    cfg.update(name="dummy_config", batch=16)
    (root / "benchmark/configs/dummy_config.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/dummy_mix.json").write_text(json.dumps(
        {"episode_units": 7, "draws": [], "kick": {"period": 3, "range": [0.0, 0.1]}}))
    (root / "benchmark/metrics/dummy_metric.py").write_text(
        "def read(record):\n    return 42.0\n")
    (root / "benchmark/limits/dummy_cell.json").write_text(json.dumps({"clock_s.max": 1.0}))
    data["configs"].append({"name": "dummy_config", "source": "https://example.org",
                            "file": "benchmark/configs/dummy_config.json", "reduced": [],
                            "why": "test"})
    data["workloads"].append({"name": "dummy_cell", "config": "dummy_config",
                              "traffic": "dummy_mix", "chips": 1, "why": "test"})
    for m in data["end_to_end"]:
        if m["name"] == "mpc_solves_per_s":
            m["workloads"].append("dummy_cell")
    data["per_layer"].append({"name": "dummy_metric", "unit": "%", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "mpc_solves_per_s", "workloads": ["dummy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    cell = manifest.resolve("dummy_cell", root)
    assert cell.config["batch"] == 16 and cell.traffic["episode_units"] == 7
    assert [m.name for m in cell.per_layer] == ["dummy_metric"]
    assert cell.per_layer[0].reader.read({}) == 42.0
    assert {m.name for m in cell.end_to_end} == {"mpc_solves_per_s", "setup_s"}
    for path, content in before.items():
        assert path.read_bytes() == content
    # The old cells still resolve as before.
    assert manifest.resolve("srbd_gait_4096", root).config["batch"] == 4096


def test_unknown_cell_fails():
    with pytest.raises(KeyError):
        manifest.resolve("no_such_cell", ROOT)
