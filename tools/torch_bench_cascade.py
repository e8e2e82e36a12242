"""The batched control period on one card: the PyTorch port's counterpart
of ``tools/bench_cascade.py``.

    python3 tools/torch_bench_cascade.py [B] [PERIODS]

The default ``EngineConfig`` (matmul inverses: kernel B1, 748 launches a
period) at B (default 2048) instances of ``default_scenario`` from
``init_state``: one warm-up period, then PERIODS (default 2) periods each
timed by CUDA events; ms a period, ticks/s (B x 40 a period) and periods/s.
Prints one JSON line with the card's name and power limit. Needs a card;
raises without one.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from statistics import median

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from chip_smoke import gpu_line  # noqa: E402
from g1_locomotion_tpu_torch._device import require_cuda  # noqa: E402
from g1_locomotion_tpu_torch.engine import tick as eng  # noqa: E402
from g1_locomotion_tpu_torch.models.robot import load_robot  # noqa: E402
from g1_locomotion_tpu_torch.ops import cuda_lin  # noqa: E402


def main(argv) -> None:
    B = int(argv[0]) if argv else 2048
    periods = int(argv[1]) if len(argv) > 1 else 2
    device, dtype = require_cuda(), torch.float32
    model = load_robot("g1_23dof", device=device, dtype=dtype)
    cfg = eng.EngineConfig()
    loop = eng.ControlLoop(model, cfg)
    params = eng.default_scenario(device=device, dtype=dtype)
    state = eng.init_state(model, cfg, B, dtype)
    state, _ = loop.period(state, params)  # warm: builds the kernels
    ms = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cuda_lin.reset_launch_counts()
    for _ in range(periods):
        torch.cuda.synchronize()
        start.record()
        state, _ = loop.period(state, params)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    per = median(ms)
    print(json.dumps({
        "metric": "cascade_period_ms", "gpu": gpu_line(), "batch": B, "periods": periods,
        "period_ms": ms, "median_ms": per,
        "ticks_per_s": B * cfg.ticks_per_mpc / (per / 1e3), "periods_per_s": B / (per / 1e3),
        "launches_per_period": {k: v / periods for k, v in cuda_lin.launch_counts().items()},
        "clock": "CUDA events",
    }))


if __name__ == "__main__":
    main(sys.argv[1:])
