"""End to end, the serving configuration controls as the default one does,
on one card: the PyTorch port's counterpart of
``tools/validate_serving_tick.py``.

    python3 tools/torch_validate_serving_tick.py [PERIODS]

Runs the control period (MPC, 40 WBID ticks, the plant) for PERIODS
(default 25) periods at float32, B = 1, from the same ``init_state`` and
``default_scenario``, in the default ``EngineConfig`` (kernel B1) and in
the serving configuration (``polish_kernel`` on both QPs, ``fast_stack``:
kernels B2, B3, B4), and compares the realized trajectories: the final CoM
heights within 1 cm, the serving run's lowest CoM above 0.55 m, |tau| below
88 N m, every value finite. Prints one JSON line per configuration and a
verdict line; exits 1 when the check fails. Needs a card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import gpu_line  # noqa: E402
from g1_locomotion_tpu_torch._device import require_cuda  # noqa: E402
from g1_locomotion_tpu_torch.engine import tick as eng  # noqa: E402
from g1_locomotion_tpu_torch.models.robot import load_robot  # noqa: E402


def main(argv) -> None:
    periods = int(argv[0]) if argv else 25
    device, dtype = require_cuda(), torch.float32
    model = load_robot("g1_23dof", device=device, dtype=dtype)
    base = eng.EngineConfig()
    serving = base._replace(
        mpc=base.mpc._replace(qp=base.mpc.qp._replace(polish_kernel=True)),
        wbid=base.wbid._replace(qp=base.wbid.qp._replace(polish_kernel=True), fast_stack=True))
    params = eng.default_scenario(device=device, dtype=dtype)
    out = {}
    for name, cfg in (("default", base), ("serving", serving)):
        loop = eng.ControlLoop(model, cfg)
        _, log = loop.rollout(eng.init_state(model, cfg, 1, dtype), params, periods)
        com = log.com.double().cpu().numpy().reshape(-1, 3)
        tau = log.tau.double().cpu().numpy()
        out[name] = {"com_final": com[-1].tolist(), "z_min": float(com[:, 2].min()),
                     "xy_drift": float(np.abs(com[-1, :2] - com[0, :2]).max()),
                     "tau_max": float(np.abs(tau).max()),
                     "finite": bool(np.isfinite(com).all() and np.isfinite(tau).all())}
        print(json.dumps({name: out[name]}), flush=True)
    d = abs(out["serving"]["com_final"][2] - out["default"]["com_final"][2])
    ok = (out["serving"]["finite"] and out["default"]["finite"] and d < 0.01
          and out["serving"]["z_min"] > 0.55 and out["serving"]["tau_max"] < 88.0)
    print(json.dumps({"gpu": gpu_line(), "periods": periods,
                      "serving_matches_default_z_mm": d * 1e3, "ok": ok}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main(sys.argv[1:])
