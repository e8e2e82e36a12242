"""The MuJoCo bridge's controller tick, on the plain reference.

One tick on a measured state, as the reference system's bridge runs it
(ros_run_simulation.py:341-519): the measurement replaces the carried
whole-body state (MuJoCo's free-joint linear velocity turned from the world
frame into the base frame), the MPC stage runs every ``ticks_per_mpc``
ticks, then one control tick with the phase of the tick within the MPC's
prediction interval.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.g1ref.core import rotations as rot
from benchmark.reference.g1ref.engine import plant as plant_mod
from benchmark.reference.g1ref.engine import tick as eng
from benchmark.reference.g1ref.models import robot as rb


def base_local_velocity(qpos: np.ndarray, qvel: np.ndarray) -> np.ndarray:
    R = rot.quat_to_matrix(torch.as_tensor(np.asarray(qpos[3:7], dtype=np.float64))).numpy()
    v = np.array(qvel, dtype=np.float64)
    v[:3] = R.T @ v[:3]
    return v


class Bridge:
    """``reset(qpos, qvel)`` and ``step(qpos, qvel) -> (tau, log)`` like the
    program's controller; ``step_from`` is the same tick as a function of a
    given carried state and tick counter."""

    def __init__(self, model, cfg: eng.EngineConfig, params: eng.ScenarioParams):
        self.model, self.cfg, self.params = model, cfg, params
        self.loop = eng.ControlLoop(model, cfg)
        self.state = None
        self.tick = 0

    def measured(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
            self.model.device, self.model.dtype)[None]

    def reset_state(self, qpos: np.ndarray, qvel: np.ndarray) -> eng.EngineState:
        model, idx = self.model, self.loop.idx
        q = self.measured(qpos)
        feet, feet_R = eng._feet(model, idx, rb.fk(model, q))
        return eng.init_state(model, self.cfg, 1, model.dtype)._replace(
            q=q, v=self.measured(base_local_velocity(qpos, qvel)),
            contact_hold=feet, contact_hold_R=feet_R, swing_start=feet,
            swing_xy_ref=feet[..., :2], anchors=plant_mod.anchors_from_state(model, idx, q))

    def reset(self, qpos: np.ndarray, qvel: np.ndarray) -> None:
        self.state = self.reset_state(qpos, qvel)
        self.tick = 0

    def step_from(self, state: eng.EngineState, t: int, qpos: np.ndarray, qvel: np.ndarray):
        """(the carried state after the tick, the tick's log, the MPC stage's
        solution or None)."""
        cfg = self.cfg
        state = state._replace(q=self.measured(qpos),
                               v=self.measured(base_local_velocity(qpos, qvel)))
        sol = None
        if t % cfg.ticks_per_mpc == 0:
            state, sol = self.loop._mpc_stage(self.params, state)
        a = min(((t % cfg.ticks_per_mpc) + 1.0) * cfg.plant.dt / cfg.mpc.dt, 1.0)
        state, log = self.loop._tick(self.params, state, (1.0 - a, a))
        return state, log, sol

    def step(self, qpos: np.ndarray, qvel: np.ndarray):
        self.state, log, _ = self.step_from(self.state, self.tick, qpos, qvel)
        self.tick += 1
        return log.tau[0].cpu().numpy(), log
