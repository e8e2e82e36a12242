"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Top-level module names are compared
whole: the port's name, g1_locomotion_tpu_torch, begins with the JAX
package's."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
JAX_NAMES = {"jax", "jaxlib", "flax", "g1_locomotion_tpu"}

PROBE = """
import importlib, json, sys
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
from benchmark.harness import manifest
for path in {files!r}:
    manifest.load_module(manifest.ROOT / path)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(modules, files=()):
    code = PROBE.format(root=str(ROOT), modules=list(modules), files=list(files))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def bench_files():
    files = [p.relative_to(ROOT).as_posix()
             for sub in ("metrics", "drivers")
             for p in sorted((ROOT / "benchmark" / sub).glob("*.py"))]
    return files + ["benchmark/run.py", "benchmark/readings.py"]


def test_benchmark_and_program_load_no_jax():
    top = loaded(["benchmark.harness.base", "g1_locomotion_tpu_torch.engine.tick",
                  "g1_locomotion_tpu_torch.engine.mujoco_bridge",
                  "g1_locomotion_tpu_torch.parallel.sweep",
                  "g1_locomotion_tpu_torch.mpc.srbd_loop"], bench_files())
    assert not top & JAX_NAMES, top & JAX_NAMES
    assert "g1_locomotion_tpu_torch" in top


def test_reference_loads_nothing_of_the_program():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted((ROOT / "benchmark" / "reference").rglob("*.py"))]
    top = loaded([m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods])
    assert not top & (JAX_NAMES | {"g1_locomotion_tpu_torch"}), top


def test_configs_and_mixes_are_data():
    for sub in ("configs", "traffic", "limits"):
        for p in (ROOT / "benchmark" / sub).iterdir():
            assert p.suffix == ".json", p
            json.loads(p.read_text())
