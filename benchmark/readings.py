"""Readings for the correctness limits: one cell over many seeds in one
process, the program and the control, each run's compared quantities.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds 40] [--out chiprun_out/readings.jsonl]

The control is the plain reference put in the program's place at the
configuration's dtype with TF32 on (the nearest precision below the float32
the configurations state, whose products the port runs in IEEE fp32); the
check after its window is the same float64 reference. Prints one JSON line
a run (side, seed, correct, the end-to-end metrics, every reading). Not run
by the benchmark's own runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.harness import manifest  # noqa: E402


def control_precision(on: bool) -> None:
    """TF32 for float32 products on the card (the control), or IEEE fp32."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--check-units", type=int, default=0,
                    help="units the check samples of each stratum, where not the "
                         "configuration's")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = manifest.resolve(args.workload)
    if args.check_units:
        cell = cell._replace(config=dict(cell.config, check_units={
            k: args.check_units for k in cell.config["check_units"]}))
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    warm = True
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            control_precision(side == "control")
            t0 = time.perf_counter()
            res = run.run_cell(cell, seed, args.seconds, bool(args.trace), device, side,
                               warm=warm)
            control_precision(False)
            warm = False
            line = {"cell": cell.name, "side": side, "seed": seed, "correct": res["correct"],
                    "attempted": res["attempted"], "metrics": res["metrics"],
                    "device": res["device"], "seconds": time.perf_counter() - t0,
                    "readings": res["readings"], "breakdown": res.get("breakdown")}
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
