"""The MuJoCo bars on the PyTorch port: one closed loop of the port's
cascade against real MuJoCo contacts (``engine/mujoco_bridge.MujocoLoop``,
float64), with the assertions of the JAX package's test that it names.

    python3 tools/torch_mujoco_bar.py --config {stand_1s,walk_6,quiet_3s,push,nominal}
                                      [--device cpu]

* ``stand_1s``: 1 s of standing (``test_standing_balance_in_mujoco``);
* ``walk_6``: 6 steps and the settle, 5.6 s, ``walking_config`` with
  ``mujoco_walking_scenario`` (``test_walking_in_mujoco``);
* ``quiet_3s``: 3 s of quiet standing (``test_standing_quiet_3s_in_mujoco``);
* ``push``: 1 s of standing, a (0.15, 0.10) m/s push, 2.5 s more
  (``test_push_recovery_in_mujoco``);
* ``nominal``: ``mujoco_nominal_config`` with ``mujoco_nominal_scenario``
  until the gait clock passes 5 steps, at most 6 s
  (``test_nominal_gait_mujoco_progress``);

all in tests/test_engine_mujoco.py; the standing ones with
``mujoco_standing_scenario``. MuJoCo runs on the host; the controller on
the card, or on ``--device``. Needs the ``mujoco`` package. The last line
printed is one JSON object: the configuration, the device (and the card's
name and power limit), the ticks and seconds, every checked value and
``"held"``: whether every assertion held. Exits 1 when the bar fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from g1_locomotion_tpu_torch._device import require_cuda  # noqa: E402
from g1_locomotion_tpu_torch.core import rotations as rot  # noqa: E402
from g1_locomotion_tpu_torch.engine import tick as eng  # noqa: E402
from g1_locomotion_tpu_torch.engine.mujoco_bridge import MujocoLoop  # noqa: E402
from g1_locomotion_tpu_torch.models import robot as rb  # noqa: E402
from g1_locomotion_tpu_torch.wbid.stack import StackIndices  # noqa: E402

CONFIGS = ("stand_1s", "walk_6", "quiet_3s", "push", "nominal")
F64 = torch.float64


def _rpy_max(loop) -> float:
    q = torch.tensor(loop.mj_data.qpos[3:7], dtype=F64)
    return float(rot.quat_to_rpy(q)[:2].abs().max())


def standing_bar(loop, ticks: int) -> dict:
    """``ticks`` of standing in MuJoCo from the loop's settled state, with
    ``test_standing_balance_in_mujoco``'s invariants that hold at any depth
    (the height change, roll and pitch, the torques; each joint's torque
    against its own limit, which implies the test's bound by the largest
    limit): {name: (value, bound, held)}. ``stand_1s`` runs 1000 ticks;
    chip_smoke.py's phase 17 runs 200 on the card."""
    z0 = float(loop.mj_data.qpos[2])
    log = loop.run(ticks)
    finite = bool(np.isfinite(log["com"]).all() and np.isfinite(log["tau"]).all())
    dz, rpy = abs(float(loop.mj_data.qpos[2]) - z0), _rpy_max(loop)
    over = float((np.abs(log["tau"]) - loop.tau_max).max())
    return {"finite": (finite, True, finite), "dz": (dz, "< 0.06", dz < 0.06),
            "rpy_abs_max": (rpy, "< 0.2", rpy < 0.2),
            "tau_over_max": (over, "<= 1e-6", over <= 1e-6)}


def bar(config: str, device) -> dict:
    """Run one bar: {name: (value, bound, held)}, plus "ticks"."""
    model = rb.load_robot("g1_23dof", device=device, dtype=F64)
    if config == "walk_6":
        loop = MujocoLoop(model, cfg=eng.walking_config(), params=eng.mujoco_walking_scenario(
            device=device, dtype=F64, n_steps=6.0, v_cmd=(0.1, 0.0)))
    elif config == "nominal":
        loop = MujocoLoop(model, cfg=eng.mujoco_nominal_config(),
                          params=eng.mujoco_nominal_scenario(device=device, dtype=F64,
                                                             n_steps=8.0, v_cmd=(0.1, 0.0)))
    else:
        loop = MujocoLoop(model, params=eng.mujoco_standing_scenario(device=device, dtype=F64))
    qvel_max = lambda: float(np.abs(loop.mj_data.qvel).max())  # noqa: E731
    if config == "stand_1s":
        # Quiet by 1 s: the test's convergence check, which only this depth has.
        out = {"ticks": 1000, **standing_bar(loop, 1000)}
        out["qvel_abs_max"] = (qvel_max(), "< 0.5", qvel_max() < 0.5)
        return out
    if config == "nominal":
        target, t, fell = 0.5 + 5.0 * 0.5, 0, False
        while float(loop.state.gait_clock[0]) < target and t < 6000:
            com = loop.run(250)["com"]
            t += 250
            if not np.isfinite(com).all() or com[:, 2].min() < 0.42:
                fell = True
                break
        clock = float(loop.state.gait_clock[0])
        return {"ticks": t, "fell": (fell, False, not fell),
                "gait_clock": (clock, f">= {target}", clock >= target)}
    if config == "push":
        loop.run(1000)
        loop.mj_data.qvel[0] += 0.15
        loop.mj_data.qvel[1] += 0.10
    ticks = {"walk_6": 5600, "quiet_3s": 3000, "push": 2500}[config]
    com = loop.run(ticks)["com"]
    finite = bool(np.isfinite(com).all())
    z_min, z_err = float(com[:, 2].min()), float(abs(com[-1, 2] - 0.598))
    out = {"ticks": ticks + (1000 if config == "push" else 0), "finite": (finite, True, finite)}
    z_bar, err_bar, v_bar = {"walk_6": (0.42, 0.02, 0.3), "quiet_3s": (0.50, 5e-3, 0.05),
                             "push": (0.5, 0.01, 0.3)}[config]
    out["com_z_min"] = (z_min, f"> {z_bar}", z_min > z_bar)
    out["com_z_final_err"] = (z_err, f"< {err_bar}", z_err < err_bar)
    out["qvel_abs_max"] = (qvel_max(), f"< {v_bar}", qvel_max() < v_bar)
    if config == "walk_6":
        out["rpy_abs_max"] = (_rpy_max(loop), "< 0.1", _rpy_max(loop) < 0.1)
        X = rb.fk(model, torch.tensor(loop.mj_data.qpos, dtype=F64, device=device)[None])
        feet_x = [float(rb.frame_pose(model, X, f).p[0, 0])
                  for f in StackIndices.from_model(model).feet]
        out["feet_x_min"] = (min(feet_x), "> 0.25", min(feet_x) > 0.25)
        adv = float(com[-1, 0] - com[0, 0])
        out["com_x_advance"] = (adv, "> 0.28", adv > 0.28)
    return out


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True, choices=CONFIGS)
    ap.add_argument("--device", default=None, help="the controller's device (default: the card)")
    args = ap.parse_args(argv)
    device = require_cuda() if args.device is None else torch.device(args.device)
    card = gpu_line() if device.type == "cuda" else None
    t0 = time.perf_counter()
    res = bar(args.config, device)
    seconds = time.perf_counter() - t0
    ticks = res.pop("ticks")
    held = all(ok for _, _, ok in res.values())
    for name, (value, bound, ok) in res.items():
        print(f"{args.config} {name}: {value} (bar {bound}): {'held' if ok else 'FAILED'}")
    print(json.dumps({"config": args.config, "device": str(device), "card": card,
                      "ticks": ticks, "seconds": seconds, "seconds_per_tick": seconds / ticks,
                      "checks": {k: v[0] for k, v in res.items()}, "held": held,
                      "failed": [k for k, v in res.items() if not v[2]]}))
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
