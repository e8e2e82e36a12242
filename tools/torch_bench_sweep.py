"""The pod sweep (BASELINE config 5) on one card: the batch users' workload.

    python3 tools/torch_bench_sweep.py [--scenarios N] [--periods P] [--profile]

``parallel/sweep.run_sweep`` over ``SweepSpec(N)`` (default 4096)
scenarios drawn by ``randomize`` from a CPU generator of seed 0 (SRBD mass
and inertia, WBID mu, swing duration, step length and v_cmd per instance),
the default ``EngineConfig`` at float32: one warm-up period, then P
(default 2) periods, each timed by a CUDA event pair; ms a period,
scenario-periods/s and scenario-ticks/s (N x 40 a period), B1's launches a
period. ``--profile`` adds ``torch.profiler`` over one more period: the
device's busy share of the wall time and the device time by kind of
kernel. Prints JSON lines with the card's name and power limit. Needs a
card; raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from statistics import median

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from chip_smoke import gpu_line, op_kind, profile_path  # noqa: E402
from g1_locomotion_tpu_torch._device import require_cuda  # noqa: E402
from g1_locomotion_tpu_torch.engine import tick as eng  # noqa: E402
from g1_locomotion_tpu_torch.models.robot import load_robot  # noqa: E402
from g1_locomotion_tpu_torch.ops import cuda_lin  # noqa: E402
from g1_locomotion_tpu_torch.parallel import sweep  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--scenarios", type=int, default=4096)
    p.add_argument("--periods", type=int, default=2)
    p.add_argument("--profile", action="store_true")
    args = p.parse_args(argv)
    device, dtype, gpu = require_cuda(), torch.float32, gpu_line()
    model = load_robot("g1_23dof", device=device, dtype=dtype)
    loop = eng.ControlLoop(model, eng.EngineConfig())
    params = sweep.randomize(sweep.SweepSpec(n_scenarios=args.scenarios),
                             torch.Generator().manual_seed(0),
                             eng.default_scenario(device=device, dtype=dtype))
    state, _, _ = sweep.run_sweep(loop, params, 1)  # warm: builds the kernels
    ms = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cuda_lin.reset_launch_counts()
    for _ in range(args.periods):
        torch.cuda.synchronize()
        start.record()
        state, _, stats = sweep.run_sweep(loop, params, 1, states0=state)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    per = median(ms)
    T = loop.cfg.ticks_per_mpc
    print(json.dumps({
        "metric": "pod_sweep_period_ms", "gpu": gpu, "scenarios": args.scenarios,
        "period_ms": ms, "median_ms": per,
        "scenario_periods_per_s": args.scenarios / (per / 1e3),
        "scenario_ticks_per_s": args.scenarios * T / (per / 1e3),
        "launches_per_period": {k: v / args.periods for k, v in cuda_lin.launch_counts().items()},
        "fell_count": float(stats.fell_count), "clock": "CUDA events",
    }), flush=True)
    if args.profile:
        profile_path(f"pod sweep B={args.scenarios}",
                     lambda: sweep.run_sweep(loop, params, 1, states0=state), 1, "period", gpu,
                     by=op_kind)


if __name__ == "__main__":
    main()
