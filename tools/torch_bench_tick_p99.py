"""The serving tick's and the serving period's latency on one card: the
PyTorch port's counterpart of ``tools/bench_tick_p99.py`` (and, with
``--split``, of ``tools/exp_tick_split.py``).

    python3 tools/torch_bench_tick_p99.py [--ticks N] [--periods P] [--split]

* The WBID serving tick (``polish_kernel``, ``fast_stack``; kernels B2, B3,
  B4) at B = 1: N (default 200) data-dependent ticks from the standing
  pose, 20 in double support then the left foot swinging
  (``chip_smoke.serving_chain``'s chain), each timed on the host clock
  around a synchronized tick: p50 / p99.
* The serving control period (the MPC solve, 40 ticks, the plant) at
  B = 1 from ``init_state``, ``default_scenario``: P (default 25)
  periods, each timed the same way: p50 / p99 per period and per tick.
* ``--split``: the same periods with ``EngineConfig.telemetry`` on, so that
  each period's MPC solve and each tick's WBID solve are timed by CUDA
  events: p50 / p99 of each, and the rest of the period (planner, FK,
  references, plant) as the period's own CUDA-event time less the two.

Prints one JSON line per measurement, each with the card's name and power
limit. Needs a card; raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import gpu_line, serving_chain, wbid_configs  # noqa: E402
from g1_locomotion_tpu_torch._device import require_cuda  # noqa: E402
from g1_locomotion_tpu_torch.engine import tick as eng  # noqa: E402
from g1_locomotion_tpu_torch.models.robot import load_robot  # noqa: E402
from g1_locomotion_tpu_torch.wbid.solver import WBIDSolver  # noqa: E402
from g1_locomotion_tpu_torch.wbid.tasks import default_gains  # noqa: E402


def serving(cfg: eng.EngineConfig) -> eng.EngineConfig:
    return cfg._replace(
        mpc=cfg.mpc._replace(qp=cfg.mpc.qp._replace(polish_kernel=True)),
        wbid=cfg.wbid._replace(qp=cfg.wbid.qp._replace(polish_kernel=True), fast_stack=True))


def pct(x) -> dict:
    x = np.asarray(x)
    return {"p50": float(np.percentile(x, 50)), "p99": float(np.percentile(x, 99)),
            "mean": float(x.mean()), "max": float(x.max()), "samples": int(x.size)}


class _TimedSolver:
    """A WBID solver whose every call is timed on the host clock, synchronized."""

    def __init__(self, solver):
        self.solver, self.ms = solver, []

    def __call__(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.solver(*args)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--ticks", type=int, default=200)
    p.add_argument("--periods", type=int, default=25)
    p.add_argument("--split", action="store_true")
    args = p.parse_args(argv)
    device, dtype, gpu = require_cuda(), torch.float32, gpu_line()
    model = load_robot("g1_23dof", device=device, dtype=dtype)

    solver = WBIDSolver(wbid_configs()[0], model, default_gains(device=device, dtype=dtype))
    serving_chain(solver, solver.model, solver.idx, device, dtype, ticks=5)  # warm
    timed = _TimedSolver(solver)
    serving_chain(timed, solver.model, solver.idx, device, dtype, ticks=args.ticks)
    print(json.dumps({"metric": "wbid_serving_tick_ms", "gpu": gpu, **pct(timed.ms),
                      "clock": "host, synchronized"}), flush=True)

    cfg = serving(eng.EngineConfig(telemetry=args.split))
    loop = eng.ControlLoop(model, cfg)
    params = eng.default_scenario(device=device, dtype=dtype)
    state = eng.init_state(model, cfg, 1, dtype)
    loop.period(state, params)  # warm
    period_ms, event_ms, mpc_ms, wbid_ms = [], [], [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(args.periods):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        state, log = loop.period(state, params)
        end.record()
        torch.cuda.synchronize()
        period_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
        mpc_ms.append(float(log.mpc_ms[0, 0]))
        wbid_ms.append(log.wbid_ms[0].cpu().numpy())
    T = cfg.ticks_per_mpc
    print(json.dumps({"metric": "serving_period_ms", "gpu": gpu, **pct(period_ms),
                      "per_tick_p50": float(np.percentile(period_ms, 50)) / T,
                      "telemetry": args.split, "clock": "host, synchronized"}), flush=True)
    if args.split:
        wbid_sum = [float(w.sum()) for w in wbid_ms]
        rest = [e - m - w for e, m, w in zip(event_ms, mpc_ms, wbid_sum)]
        print(json.dumps({"metric": "serving_period_split_ms", "gpu": gpu,
                          "period_events": pct(event_ms), "mpc_solve": pct(mpc_ms),
                          "wbid_solve_per_tick": pct(np.concatenate(wbid_ms)),
                          "wbid_solves_per_period": pct(wbid_sum), "rest_of_period": pct(rest),
                          "stage_segments": loop.graph_counts(), "clock": "CUDA events"}),
              flush=True)


if __name__ == "__main__":
    main()
