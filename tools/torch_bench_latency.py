"""The MPC serving solve's latency on one card: the PyTorch port's
counterpart of ``tools/bench_latency.py``.

    python3 tools/torch_bench_latency.py [SOLVES]

B = 1 solves in the serving configuration (``bench.py``'s QP settings with
``polish_kernel``: kernels B2, B3 and B4), each one's input moved by the
one before (a data-dependent chain), timed one by one on the host clock
around a synchronized solve: p50 / p99 / mean over SOLVES (default 1000)
after 20 warm-up solves, and the mean device time per solve (CUDA events
around the whole chain). Prints one JSON line with the card's name and
power limit. Needs a card; raises without one.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import bench_inputs, configs, gpu_line, solver_for  # noqa: E402
from g1_locomotion_tpu_torch._device import require_cuda  # noqa: E402


def main(argv) -> None:
    solves = int(argv[0]) if argv else 1000
    device = require_cuda()
    solver = solver_for(configs()[1], device, torch.float32)
    inp = bench_inputs(1, device, torch.float32)
    x = inp["x0"]

    def solve(x):
        sol = solver(x, inp["x_ref"], inp["contact"], inp["c_hor"], inp["p_hor"])
        return x + 1e-9 * torch.nn.functional.pad(sol.u0, (0, 1))

    for _ in range(20):
        x = solve(x)
    lat = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(solves):
        t0 = time.perf_counter()
        x = solve(x)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    end.record()
    torch.cuda.synchronize()
    lat = np.asarray(lat)
    print(json.dumps({
        "metric": "mpc_serving_solve_latency_ms", "gpu": gpu_line(), "samples": solves,
        "p50": float(np.percentile(lat, 50)), "p99": float(np.percentile(lat, 99)),
        "mean": float(lat.mean()), "max": float(lat.max()),
        "chain_event_ms_per_solve": start.elapsed_time(end) / solves,
        "clock": "host, synchronized after each solve",
    }))


if __name__ == "__main__":
    main(sys.argv[1:])
