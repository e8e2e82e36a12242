"""The cascade demos of api/demos.py of the PyTorch port, on the CPU at
float64, each at the smallest depth its arguments allow: the walking demo
(2 periods, with its log and plot), push recovery at horizon 20 and the
carry walk (1 period). The two demos whose depth is fixed, walking in
MuJoCo and the 29-DoF cascade, run with the loop's ``run`` / ``rollout``
cut short (50 ticks after the settle, 1 period), and the test checks the
depth they asked for. Each returns the reference demo's result keys
(g1_locomotion_tpu/api/demos.py) and the device it ran on, with finite
values (the CLI's wiring is tests/test_torch_demos.py's).
"""

import json

import numpy as np
import pytest

from g1_locomotion_tpu_torch.api import demos
from g1_locomotion_tpu_torch.engine import tick as eng
from g1_locomotion_tpu_torch.utils import viz

KEYS = {
    "walking": {"config", "sim_seconds", "wall_seconds", "final_com", "com_x_travel", "fell"},
    "walking_mujoco": {"config", "n_steps", "sim_seconds", "wall_seconds", "final_com",
                       "com_x_travel", "final_qvel_max", "fell", "solve_stats"},
    "push_recovery": {"config", "horizon", "push", "final_com", "residual_speed", "recovered"},
    "wbid_29dof": {"config", "nv", "final_com", "stable"},
    "carry_walk_29dof_with_hand": {"config", "nv", "z_min", "z_final", "v_final_max",
                                   "rpy_final_max", "steps", "walks"},
}


def _check(out, config):
    assert out["config"] == config and out["device"] == "cpu"
    assert set(out) == KEYS[config] | {"device"}
    assert np.isfinite(out["final_com"] if "final_com" in out else out["z_final"]).all()
    # A period or two from the standing start: the CoM stays near its height.
    z = out["final_com"][2] if "final_com" in out else out["z_final"]
    assert 0.55 < z < 0.65, out


def test_walking_demo_log_and_plot(tmp_path):
    log, plot = tmp_path / "walk.npz", tmp_path / "walk.png"
    out = demos.demo_walking(seconds=0.08, device="cpu", log_path=str(log), plot_path=str(plot))
    _check(out, "walking")
    assert not out["fell"]
    saved = viz.load_log(str(log))
    assert saved["com"].shape == (2, 40, 3) and saved["tau"].shape == (2, 40, 23)
    assert plot.stat().st_size > 10_000 and (tmp_path / "walk_plan.png").exists()


def test_walking_mujoco_demo(monkeypatch):
    pytest.importorskip("mujoco")
    from g1_locomotion_tpu_torch.engine import mujoco_bridge

    asked, run = [], mujoco_bridge.MujocoLoop.run

    def short_run(loop, n_ticks, **kw):
        asked.append(n_ticks)
        return run(loop, 50, **kw)

    monkeypatch.setattr(mujoco_bridge.MujocoLoop, "run", short_run)
    out = demos.demo_walking_mujoco(device="cpu")
    _check(out, "walking_mujoco")
    # 0.5 s of standing, 6 steps of 0.6 s, 1.5 s of settle.
    assert asked == [5600] and out["sim_seconds"] == 5.6 and out["n_steps"] == 6
    assert not out["fell"]
    stats = json.loads(out["solve_stats"])
    assert {t["name"]: t["n"] for t in stats["timers"]} == {"mpc_solve": 2, "wbid_solve": 50}


def test_push_recovery_demo():
    out = demos.demo_push_recovery(seconds=0.04, device="cpu")
    _check(out, "push_recovery")
    assert out["horizon"] == 20 and out["push"] == [0.25, 0.15]
    assert out["residual_speed"] > 0.0


def test_wbid_29dof_demo(monkeypatch):
    asked, rollout = [], eng.ControlLoop.rollout

    def short_rollout(loop, state, params, n_periods):
        asked.append(n_periods)
        return rollout(loop, state, params, 1)

    monkeypatch.setattr(eng.ControlLoop, "rollout", short_rollout)
    out = demos.demo_wbid_29dof(device="cpu")
    _check(out, "wbid_29dof")
    assert asked == [10]
    assert out["nv"] == 35 and out["stable"]


def test_carry_walk_demo():
    out = demos.demo_carry_walk(n_periods=1, device="cpu")
    _check(out, "carry_walk_29dof_with_hand")
    assert out["nv"] > 35 and out["steps"] == [0, 0]
