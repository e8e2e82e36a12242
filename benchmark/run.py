"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is resolved by name from
``BENCHMARK.json`` (``harness/manifest.py``). Set-up builds the system,
draws the traffic from the seed and warms up every shape; the window then
runs the cell's units (ticks or periods) for ``--seconds`` (``--trace 0``);
with ``--trace 1`` it runs the configuration's ``span_units`` units without
the profiler, whose spans inside the program (the controller's own timers)
the per-layer metrics read, then its ``trace_units`` under
``torch.profiler``. After the window the plain reference checks what the
window produced, and the last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``), then ``checks``: each compared number with its
limit, which the last lines of standard error repeat.

Exits 2 without a result where PyTorch sees no card (or fewer than the cell
asks for), and 3 where ``jax``, ``jaxlib``, ``flax`` or
``g1_locomotion_tpu`` has been imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Every build and kernel cache of the program at a fixed path in the
# checkout (the port builds its kernels into g1_locomotion_tpu_torch/_build).
CACHE = ROOT / ".bench_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "nv"))
os.environ.setdefault("USE_FLAX", "0")
# One process with one host thread: the host's share of the machine is the
# same in every run, and no pool of worker threads spins beside the
# dispatch of the program's ops.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import gc  # noqa: E402

import torch  # noqa: E402

from benchmark.harness import compare, manifest, trace as tr  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "g1_locomotion_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    load (compared whole: ``g1_locomotion_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def finite(x: float) -> float:
    """x, or 1e308 where it is not finite (JSON has no inf or NaN)."""
    return x if math.isfinite(x) else 1e308


def power_limit_w():
    """The card's power limit [W] from nvidia-smi, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class B1Launches:
    """Records the shape of every call of the program's B1 wrapper
    (``ops/cuda_lin.chol_inverse_base``, which ``ops/lin.py`` calls through
    the module) while the traced window runs: the work of each launch."""

    def __init__(self):
        self.shapes = []

    def __enter__(self):
        from g1_locomotion_tpu_torch.ops import cuda_lin

        self.module, self.original = cuda_lin, cuda_lin.chol_inverse_base

        def wrapped(K, out=None):
            self.shapes.append((int(K.shape[0]), int(K.shape[-1]), K.dtype))
            return self.original(K, out)
        cuda_lin.chol_inverse_base = wrapped
        return self

    def __exit__(self, *exc):
        self.module.chol_inverse_base = self.original
        return False


def timed_window(driver, seconds: float) -> float:
    """Units until ``seconds`` have passed, then the device drained: the
    window's seconds, from its start to the end of its last whole unit."""
    driver.sync()
    t0 = time.perf_counter()
    while True:
        driver.step()
        if time.perf_counter() - t0 >= seconds:
            break
    driver.sync()
    return time.perf_counter() - t0


def traced_window(driver, units: int):
    """``units`` units under the profiler: (trace, the B1 launches)."""
    def body():
        for _ in range(units):
            driver.step()
        driver.sync()

    if driver.side == "program":
        with B1Launches() as b1:
            trace, _ = tr.capture(body)
        return trace, b1.shapes
    trace, _ = tr.capture(body)
    return trace, []


def run_cell(cell, seed: int, seconds: float, traced: bool, device, side: str = "program",
             t_start: float = None, warm: bool = True) -> dict:
    """Set-up, the window and the check of one run; the result object, with
    every quantity's readings under ``readings``."""
    t_start = time.perf_counter() if t_start is None else t_start
    driver = cell.driver.DRIVER(cell.config, cell.traffic, seed, device, side)
    driver.setup(warm)
    driver.sync()
    # What set-up made lives through the window: out of the collector's way.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    cuda = torch.device(device).type == "cuda"
    record = {"setup_s": setup_s, "trace": None, "b1_launches": []}
    record.update(driver.window_record())
    if traced:
        # The program's own spans first, where the profiler slows nothing.
        for _ in range(int(cell.config.get("span_units", 0))):
            driver.step()
        driver.sync()
        record["program"] = driver.program_record()
        start = driver.count
        trace, b1 = traced_window(driver, int(cell.config["trace_units"]))
        record.update(trace=trace, b1_launches=b1, window_s=tr.window_s(trace),
                      units=driver.count - start)
    else:
        record["window_s"] = timed_window(driver, seconds)
        record.update(units=driver.count, program=driver.program_record())
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    attempted = driver.count
    driver.release()
    gc.unfreeze()
    if cuda:
        torch.cuda.empty_cache()
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gaps = driver.check(device)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = allow_tf32
    correct, rows = compare.judge(gaps, cell.limits)
    failed = 0 if correct else gaps.answers()
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = m.reader.read(record)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if traced:
        trace = record["trace"]
        result["device"].update(busy_s=tr.busy_s(trace), window_s=tr.window_s(trace))
        result["breakdown"] = {"device_ops": tr.device_ops(trace),
                               "idle_gaps": tr.idle_gaps(trace)}
    result["readings"] = gaps.readings()
    result["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    cell = manifest.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                      t_start=T_START)
    limit = power_limit_w()
    if limit is not None:
        result["device"]["power_limit_w"] = limit
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}; nothing it runs may", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result.pop("readings")
    for c in checks.values():
        c["value"] = finite(c["value"])
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
