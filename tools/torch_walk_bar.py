"""The walking bar on the PyTorch port: one closed-loop walk of the whole
cascade (MPC, 40 WBID ticks and 40 plant steps a period), with the
assertions of the JAX package's test that it names.

    python3 tools/torch_walk_bar.py --config {walk64,walk_f32_robust,g1_29dof,g1_29dof_with_hand}
                                    [--out DIR]

* ``walk64``: the G1 23-DoF, ``walking_config()``, ``walking_scenario`` at
  float64, 163 periods (``tests/test_engine_walking.py:27-98``);
* ``walk_f32_robust``: ``walking_config_f32()``,
  ``walking_scenario_f32_robust`` at float32, 180 periods
  (``tests/test_engine_walking.py:157-189``);
* ``g1_29dof``: ``walking_config()``, ``variant_walking_scenario`` at
  float64, 163 periods (``tests/test_variants.py:117-149``);
* ``g1_29dof_with_hand``: ``variant_walking_config`` (torso and hand tasks),
  ``variant_walking_scenario`` at float64, 120 periods: the carry walk
  and the first 0.3 s of its settle (``tests/test_variants.py:152-192``).

The walk runs on the card (B = 1; no kernel runs on these configurations:
both QPs take the factorization path; ``walk(config, device)`` runs it on
another device). Each period's CoM and contact flags go to
``DIR/walk_bar_<config>.log`` as the walk goes, the whole log to
``DIR/walk_bar_<config>.npz`` at the end (DIR defaults to
``walk_bar_out``). The last line printed is one JSON object: the
configuration, the device, the card's name and power limit, the seconds per
period, every checked value, and ``"walks"``: whether every assertion held.
Exits 1 when the bar fails.
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
from g1_locomotion_tpu_torch.models import robot as rb  # noqa: E402
from g1_locomotion_tpu_torch.wbid.stack import StackIndices  # noqa: E402

# config: (variant, dtype, periods)
CONFIGS = {
    "walk64": ("g1_23dof", torch.float64, 163),
    "walk_f32_robust": ("g1_23dof", torch.float32, 180),
    "g1_29dof": ("g1_29dof", torch.float64, 163),
    "g1_29dof_with_hand": ("g1_29dof_with_hand", torch.float64, 120),
}


def setup(config: str, device):
    """(model, EngineConfig, ScenarioParams) of a configuration, as its JAX
    test builds them."""
    variant, dtype, _ = CONFIGS[config]
    model = rb.load_robot(variant, device=device, dtype=dtype)
    kw = dict(dtype=dtype, n_steps=8.0, v_cmd=(0.1, 0.0))
    if config == "walk64":
        return model, eng.walking_config(), eng.walking_scenario(device=device, **kw)
    if config == "walk_f32_robust":
        return (model, eng.walking_config_f32(),
                eng.walking_scenario_f32_robust(device=device, **kw))
    params = eng.variant_walking_scenario(model, **kw)
    if config == "g1_29dof":
        return model, eng.walking_config(), params
    return model, eng.variant_walking_config(model)._replace(log_q=True), params


def walk(config: str, device, progress=None):
    """Run the walk: (model, cfg, final state, log (1, periods, 40, ...))."""
    model, cfg, params = setup(config, device)
    loop = eng.ControlLoop(model, cfg)
    state = eng.init_state(model, cfg, 1)
    logs = []
    for k in range(CONFIGS[config][2]):
        state, log = loop.period(state, params)
        logs.append(log)
        if progress is not None:
            progress(k, log)
    return model, cfg, state, eng.TickLog(*(torch.stack(f, dim=1) for f in zip(*logs)))


def checks(config: str, model, cfg, final, log) -> dict:
    """{name: (value, bound, held)} for the JAX test's assertions."""
    com = log.com[0].reshape(-1, 3).double().cpu().numpy()
    contact = log.contact[0].reshape(-1, 4).double().cpu().numpy()
    left_up = (contact[:, 0] < 0.5).astype(int)
    right_up = (contact[:, 2] < 0.5).astype(int)
    v_max = float(final.v.abs().max())
    rpy = rot.quat_to_rpy(final.q[:, 3:7])[0].double().cpu().numpy()
    lat = {"walk64": 0.2, "walk_f32_robust": 0.25, "g1_29dof": 0.2,
           "g1_29dof_with_hand": 0.25}[config]
    out = {
        "finite": (bool(np.isfinite(com).all()), True, bool(np.isfinite(com).all())),
        "com_z_min": (float(com[:, 2].min()), "> 0.45", float(com[:, 2].min()) > 0.45),
        "com_y_abs_max": (float(np.abs(com[:, 1]).max()), f"< {lat}",
                          float(np.abs(com[:, 1]).max()) < lat),
        "left_steps": (int(np.clip(np.diff(left_up), 0, 1).sum()), "== 4",
                       int(np.clip(np.diff(left_up), 0, 1).sum()) == 4),
        "right_steps": (int(np.clip(np.diff(right_up), 0, 1).sum()), "== 4",
                        int(np.clip(np.diff(right_up), 0, 1).sum()) == 4),
    }
    if config != "walk_f32_robust":
        adv = float(com[-1, 0] - com[0, 0])
        out["com_x_advance"] = (adv, "> 0.25", adv > 0.25)
    if config == "g1_29dof_with_hand":
        return out  # the carry walk and the first 0.3 s of its settle
    out["com_z_final_err"] = (float(abs(com[-1, 2] - cfg.com_height)), "<= 0.02",
                              float(abs(com[-1, 2] - cfg.com_height)) <= 0.02)
    out["v_final_abs_max"] = (v_max, "< 0.3", v_max < 0.3)
    if config == "g1_29dof":
        return out
    out["rpy_final_abs_max"] = (float(np.abs(rpy[:2]).max()), "< 0.15",
                                float(np.abs(rpy[:2]).max()) < 0.15)
    if config == "walk_f32_robust":
        return out
    # walk64: the five tests of tests/test_engine_walking.py:27-98.
    out["com_y_final_abs"] = (float(abs(com[-1, 1])), "< 0.08", float(abs(com[-1, 1])) < 0.08)
    X = rb.fk(model, final.q)
    idx = StackIndices.from_model(model)
    feet_x = [float(rb.frame_pose(model, X, f).p[0, 0]) for f in idx.feet]
    out["feet_x_min"] = (min(feet_x), "> 0.25", min(feet_x) > 0.25)
    both = bool(((contact[:, 0] < 0.5) & (contact[:, 2] < 0.5)).any())
    out["both_feet_up"] = (both, False, not both)
    forces = log.forces[0].reshape(-1, 4, 3).double().cpu().numpy()
    f_sw = float(np.abs(forces[contact < 0.5]).max()) if (contact < 0.5).any() else 0.0
    out["swing_force_abs_max"] = (f_sw, "< 1e-3", f_sw < 1e-3)
    tau = log.tau[0].reshape(-1, model.nj).double().cpu().numpy()
    over = float((np.abs(tau) - model.tau_max.double().cpu().numpy()[None]).max())
    out["tau_over_limit"] = (over, "<= 1e-6", over <= 1e-6)
    return out


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True, choices=sorted(CONFIGS))
    ap.add_argument("--out", default=str(REPO / "walk_bar_out"))
    args = ap.parse_args(argv)
    device = require_cuda()
    card = gpu_line()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    trace = open(out_dir / f"walk_bar_{args.config}.log", "w")
    t0 = time.perf_counter()

    def progress(k, log):
        com = log.com[0, -1].double().cpu().tolist()
        flags = log.contact[0, -1].double().cpu().tolist()
        trace.write(f"period {k}: {time.perf_counter() - t0:.1f} s, com {com}, "
                    f"contact {flags}\n")
        trace.flush()

    with trace:
        model, cfg, final, log = walk(args.config, device, progress)
    seconds = time.perf_counter() - t0
    n = log.com.shape[1]
    np.savez_compressed(out_dir / f"walk_bar_{args.config}.npz",
                        **{k: v.double().cpu().numpy() for k, v in log._asdict().items()},
                        q_final=final.q.double().cpu().numpy(),
                        v_final=final.v.double().cpu().numpy())
    res = checks(args.config, model, cfg, final, log)
    held = all(ok for _, _, ok in res.values())
    for name, (value, bound, ok) in res.items():
        print(f"{args.config} {name}: {value} (bar {bound}): {'held' if ok else 'FAILED'}")
    print(json.dumps({
        "config": args.config, "device": str(device), "card": card, "periods": n,
        "seconds": seconds, "seconds_per_period": seconds / n,
        "checks": {k: v[0] for k, v in res.items()},
        "walks": held, "failed": [k for k, v in res.items() if not v[2]],
    }))
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
