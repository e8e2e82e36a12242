"""MuJoCo closed loop: MuJoCo steps the physics at 1 kHz, the port's MPC and
WBID cascade computes the torques.

Port of ``g1_locomotion_tpu/engine/mujoco_bridge.py`` (the original
system's own validation, ros_run_simulation.py:341-519). MuJoCo runs on the
host at float64; the controller runs on the robot model's device, the card
for a model that ``load_robot`` put there by default.

The controller is split off: :class:`BridgeController` takes the measured
MuJoCo ``qpos`` / ``qvel`` (numpy) of one tick and returns the tick's
torques (numpy), and needs no ``mujoco``; :class:`MujocoLoop` settles the
robot in MuJoCo, hands the settled state to it and steps MuJoCo with its
torques. Per tick the controller writes the measurement into its state,
runs the MPC stage every ``ticks_per_mpc`` ticks (directly, without the
period's stale-cadence swap, as the reference's bridge does), runs one tick
of :class:`~g1_locomotion_tpu_torch.engine.tick.ControlLoop` with the phase
alpha from the global tick counter, and keeps the controller's state while
the next measurement replaces the plant's. Its one host sync per tick is
the copy of tau to the host, which MuJoCo needs.

Frames (ros_run_simulation.py:354-368): MuJoCo's free-joint linear velocity
is in the world frame, the model's in the base frame; the angular velocity
is in the base frame in both; the quaternion layout (w, x, y, z) is the same.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from g1_locomotion_tpu_torch.core import rotations as rot
from g1_locomotion_tpu_torch.engine import plant as plant_mod
from g1_locomotion_tpu_torch.engine import tick as eng
from g1_locomotion_tpu_torch.engine.state import q_init_standing
from g1_locomotion_tpu_torch.gait import schedule as gs
from g1_locomotion_tpu_torch.models import robot as rb
from g1_locomotion_tpu_torch.models.mjcf import export_mjcf
from g1_locomotion_tpu_torch.models.robot import RobotModel
from g1_locomotion_tpu_torch.models.urdf import spec_from_dict
from g1_locomotion_tpu_torch.utils import pd
from g1_locomotion_tpu_torch.utils.stats import StatisticsRegistry


def base_local_velocity(qpos: np.ndarray, qvel: np.ndarray) -> np.ndarray:
    """The model's v from MuJoCo's qvel: the base's linear velocity turned
    from the world frame into the base frame."""
    R = rot.quat_to_matrix(torch.as_tensor(np.asarray(qpos[3:7], dtype=np.float64))).numpy()
    v = np.array(qvel, dtype=np.float64)
    v[:3] = R.T @ v[:3]
    return v


class BridgeController:
    """The bridge's controller, one ``ControlLoop`` tick per MuJoCo step:
    :meth:`reset` takes the settled measurement, :meth:`step` each tick's
    measurement and returns the tick's torques. Its ``stats`` time the MPC
    and WBID solves (CUDA events on the card, the host clock on the CPU) and
    count the loop's stage segments by how they ran (``graph_captured``,
    ``graph_replayed``, ``graph_eager``: ``ControlLoop.graph_counts``)."""

    def __init__(self, model: RobotModel, cfg: Optional[eng.EngineConfig] = None,
                 params: Optional[eng.ScenarioParams] = None):
        self.model = model
        self.cfg = cfg or eng.EngineConfig()
        self.params = params if params is not None else eng.default_scenario(
            device=model.device, dtype=model.dtype)
        self.loop = eng.ControlLoop(model, self.cfg)
        self.stats = StatisticsRegistry(topic="/mujoco_loop_statistics")
        self.state: Optional[eng.EngineState] = None
        # The global tick counter: the MPC cadence stays phase-continuous
        # across run() calls.
        self.tick = 0

    def _measured(self, x: np.ndarray) -> torch.Tensor:
        """(1, n) on the model's device; to the card from pinned memory, so
        that the copy is queued without a host sync."""
        t = torch.tensor(np.asarray(x, dtype=np.float64))
        if self.model.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.model.device, self.model.dtype, non_blocking=True)[None]

    def reset(self, qpos: np.ndarray, qvel: np.ndarray) -> None:
        """The standing start with the measured state, every reference
        re-anchored to the measured pose."""
        model, idx = self.model, self.loop.idx
        q = self._measured(qpos)
        feet, feet_R = eng._feet(model, idx, rb.fk(model, q))
        self.state = eng.init_state(model, self.cfg, 1, model.dtype)._replace(
            q=q, v=self._measured(base_local_velocity(qpos, qvel)),
            contact_hold=feet, contact_hold_R=feet_R, swing_start=feet,
            swing_xy_ref=feet[..., :2], anchors=plant_mod.anchors_from_state(model, idx, q))
        self.tick = 0

    def step(self, qpos: np.ndarray, qvel: np.ndarray):
        """One tick on the measured MuJoCo state: (tau (nj,) numpy, the
        tick's ``TickLog`` (1, ...) on the model's device)."""
        cfg, t = self.cfg, self.tick
        self.tick += 1
        state = self.state._replace(q=self._measured(qpos),
                                    v=self._measured(base_local_velocity(qpos, qvel)))
        clock = eng._StageClock(self.model.device)
        stages = []
        if t % cfg.ticks_per_mpc == 0:
            state, _ = self.loop._mpc_stage(self.params, state, clock)
            stages.append("mpc_solve")
        # The phase within the MPC's prediction interval (mpc.dt), not the
        # replan period.
        a = min(((t % cfg.ticks_per_mpc) + 1.0) * cfg.plant.dt / cfg.mpc.dt, 1.0)
        self.state, log = self.loop._tick(self.params, state, (1.0 - a, a), clock)
        stages.append("wbid_solve")
        tau = log.tau[0].cpu().numpy()  # the tick's one host sync
        for name, ms in zip(stages, clock.spans_ms()):
            self.stats.timer(name).samples_ms.append(ms)
        for name, n in self.loop.graph_counts().items():
            self.stats.set(f"graph_{name}", n)
        return tau, log


class MujocoLoop:
    """The closed loop: the MuJoCo plant on the host and the controller on
    the model's device (the reference's ``MujocoLoop`` and its arguments)."""

    def __init__(
        self,
        model: RobotModel,
        cfg: Optional[eng.EngineConfig] = None,
        params: Optional[eng.ScenarioParams] = None,
        variant: str = "g1_23dof",
        settle_ticks: int = 3000,
        settle_quiet: float = 0.03,
        view: bool = False,
    ):
        import mujoco

        self._mujoco = mujoco
        self.ctrl = BridgeController(model, cfg, params)
        self.model, self.cfg, self.params = model, self.ctrl.cfg, self.ctrl.params
        self.idx = self.ctrl.loop.idx
        self.tau_max = model.tau_max.double().cpu().numpy()

        spec = spec_from_dict(json.loads((rb.ASSET_DIR / f"{variant}.json").read_text()))
        self.mj_model = mujoco.MjModel.from_xml_string(export_mjcf(spec, with_floor=True))
        self.mj_data = mujoco.MjData(self.mj_model)
        self.mj_data.qpos[:] = q_init_standing(model, 1, torch.float64)[0].cpu().numpy()
        mujoco.mj_forward(self.mj_model, self.mj_data)

        # Settle onto the floor, held at q_init by a stiff joint PD on the
        # host, until the robot is quiet for a sustained stretch (the settle
        # bounces, and a single turning point has qvel ~ 0 with the contact
        # springs loaded), at least 500 ticks.
        gains = pd.default_gains(device="cpu", dtype=torch.float64)
        q0 = torch.tensor(self.mj_data.qpos[7:])
        quiet_run = 0
        for k in range(settle_ticks):
            tau = pd.pd_torques(gains, q0, torch.as_tensor(self.mj_data.qpos[7:]),
                                torch.as_tensor(self.mj_data.qvel[6:])).numpy()
            self.mj_data.ctrl[:] = np.clip(tau, -self.tau_max, self.tau_max)
            mujoco.mj_step(self.mj_model, self.mj_data)
            quiet_run = quiet_run + 1 if np.abs(self.mj_data.qvel).max() < settle_quiet else 0
            if k >= 500 and quiet_run >= 150:
                break

        self.ctrl.reset(self.read_q(), self.mj_data.qvel)
        # A live viewer, synced once per tick (the reference watches its
        # simulation live); needs a display.
        self._viewer = None
        if view:
            import mujoco.viewer

            self._viewer = mujoco.viewer.launch_passive(self.mj_model, self.mj_data)

    @property
    def state(self) -> eng.EngineState:
        return self.ctrl.state

    @property
    def stats(self) -> StatisticsRegistry:
        return self.ctrl.stats

    def read_q(self) -> np.ndarray:
        return self.mj_data.qpos.copy()

    def read_v(self) -> np.ndarray:
        return base_local_velocity(self.mj_data.qpos, self.mj_data.qvel)

    def foot_normal_forces(self) -> np.ndarray:
        """(2,) the summed ground-contact normal force per foot (L, R):
        MuJoCo's truth, the bridge's contact sensor."""
        mujoco = self._mujoco
        f, f6 = np.zeros(2), np.zeros(6)
        for ci in range(self.mj_data.ncon):
            c = self.mj_data.contact[ci]
            mujoco.mj_contactForce(self.mj_model, self.mj_data, ci, f6)
            bid = max(self.mj_model.geom_bodyid[c.geom1], self.mj_model.geom_bodyid[c.geom2])
            name = mujoco.mj_id2name(self.mj_model, mujoco.mjtObj.mjOBJ_BODY, bid) or ""
            if "left" in name:
                f[0] += f6[0]
            elif "right" in name:
                f[1] += f6[0]
        return f

    def run(self, n_ticks: int, touchdown_sync: bool = False) -> dict:
        """Run the cascade against MuJoCo for n_ticks ms: {"com" (n, 3),
        "tau" (n, nj), "fz" (n, 4)} as numpy.

        touchdown_sync (experimental, off by default, measured to
        destabilize the walk in the reference): at a swing's end (progress
        > 0.98) hold the gait clock until the swing foot's measured ground
        reaction appears, at most 250 ticks."""
        mujoco = self._mujoco
        coms, fzs, taus = [], [], []
        hold_budget = 0
        for _ in range(n_ticks):
            prev_clock = self.ctrl.state.gait_clock
            tau, log = self.ctrl.step(self.read_q(), self.mj_data.qvel)
            if touchdown_sync:
                _, in_swing, swing_is_left, progress = gs.phase_info(
                    self.params.gait, self.ctrl.state.gait_clock)
                if bool(in_swing) and float(progress) > 0.98:
                    foot = 0 if bool(swing_is_left) else 1
                    if hold_budget == 0:
                        hold_budget = 250
                    if hold_budget > 1 and self.foot_normal_forces()[foot] < 10.0:
                        self.ctrl.state = self.ctrl.state._replace(gait_clock=prev_clock)
                        hold_budget -= 1
                else:
                    hold_budget = 0
            self.mj_data.ctrl[:] = np.clip(tau, -self.tau_max, self.tau_max)
            mujoco.mj_step(self.mj_model, self.mj_data)
            if self._viewer is not None:
                if not self._viewer.is_running():
                    self._viewer = None  # the window was closed: keep simulating
                else:
                    self._viewer.sync()
            coms.append(log.com[0])
            fzs.append(log.forces[0, :, 2])
            taus.append(tau)
        return {"com": torch.stack(coms).cpu().numpy(), "tau": np.stack(taus),
                "fz": torch.stack(fzs).cpu().numpy()}
