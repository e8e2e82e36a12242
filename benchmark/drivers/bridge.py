"""One robot's controller at 1 kHz: ``BridgeController.step`` in a closed
loop (configurations with ``"driver": "bridge"``).

The loop is closed as on a robot: each tick hands the controller a measured
``qpos`` / ``qvel`` (numpy, MuJoCo's layout: the base's linear velocity in
the world frame), takes tau back on the host, and only then makes the next
measurement. The card's machine has no MuJoCo, so the next measurement is
the controller's own plant state after the tick, read back to the host and
turned into MuJoCo's layout. Episodes start standing with a drawn lateral
base velocity and last ``episode_units`` ticks.

The check: for each sampled tick (the window's first, and a sample of its
MPC ticks and of its other ticks, ``check_units['mpc']`` and
``check_units['tick']``), the plain reference runs the same tick (the MPC
stage on every ``ticks_per_mpc``-th) from the program's carried state and
the same measurement, at float64; a tick that starts an episode starts from
the reference's own reset.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import scenario as sc
from benchmark.harness.base import (Driver, engine_config, flat_state, ref_modules,
                                    scenario_of, to_tuple)
from benchmark.harness.compare import Gaps


def quat_to_matrix(quat: np.ndarray) -> np.ndarray:
    w, x, y, z = np.asarray(quat, dtype=np.float64) / np.linalg.norm(quat)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def measurement(q: np.ndarray, v: np.ndarray):
    """MuJoCo's (qpos, qvel) of the model's (q, v): the base's linear
    velocity from the base frame into the world frame."""
    qvel = np.array(v, dtype=np.float64)
    qvel[:3] = quat_to_matrix(q[3:7]) @ qvel[:3]
    return np.array(q, dtype=np.float64), qvel


class BridgeDriver(Driver):
    def _build(self) -> None:
        eng_r, est_r, rb_r, _ = ref_modules()
        # The standing measurement every episode starts from: the
        # benchmark's own (the reference's model, on the host).
        host_model = rb_r.load_robot(self.config["robot"], device="cpu", dtype=torch.float64)
        self.q_stand = est_r.q_init_standing(host_model, 1)[0].numpy()
        self.nv = host_model.nv
        if self.side == "program":
            from g1_locomotion_tpu_torch.engine import tick as eng
            from g1_locomotion_tpu_torch.engine.mujoco_bridge import BridgeController
            from g1_locomotion_tpu_torch.models.robot import load_robot

            model = load_robot(self.config["robot"], device=self.device, dtype=self.dtype)
            params = sc.apply_draws(scenario_of(eng, self.config, self.device, self.dtype),
                                    self.traffic, self.draws)
            self.system = BridgeController(model, engine_config(eng, self.config), params)
        else:
            self.system = self._reference(self.device, self.dtype)

    def _reference(self, device, dtype):
        from benchmark.reference.bridge import Bridge

        eng_r, _, rb_r, _ = ref_modules()
        model = rb_r.load_robot(self.config["robot"], device=device, dtype=dtype)
        params = sc.apply_draws(scenario_of(eng_r, self.config, device, dtype),
                                self.traffic, self.draws)
        return Bridge(model, engine_config(eng_r, self.config), params)

    def _episode_measurement(self, episode: Dict[str, torch.Tensor]):
        qvel = np.zeros(self.nv)
        vy = episode.get("init_lateral_velocity")
        if vy is not None:
            qvel[1] = float(vy[0])
        return self.q_stand.copy(), qvel

    def _start_episode(self, episode) -> None:
        with record_function("bench.reset"):
            self.qpos, self.qvel = self._episode_measurement(episode)
            self.system.reset(self.qpos, self.qvel)

    def _warm_up(self) -> None:
        self._start_episode(self.episodes[0])
        for _ in range(self.system.cfg.ticks_per_mpc + 1):
            self.step()
        self.sync()

    def _step(self, unit) -> None:
        system = self.system
        unit.update(t=system.tick, before=system.state, qpos=self.qpos, qvel=self.qvel)
        with record_function("bench.step"):
            tau, log = system.step(self.qpos, self.qvel)
        with record_function("bench.measure"):
            after = system.state
            qv = torch.cat([after.q[0], after.v[0]]).to("cpu", torch.float64).numpy()
            self.qpos, self.qvel = measurement(qv[: after.q.shape[1]], qv[after.q.shape[1]:])
        unit.update(tau=tau, forces=log.forces, after=after)

    def _stratum(self, unit) -> str:
        return "mpc" if unit["t"] % self.system.cfg.ticks_per_mpc == 0 else "tick"

    def setup(self, warm: bool = True) -> None:
        super().setup(warm)
        self.stage_mark = self._stage_counts()

    def _stage_counts(self) -> Dict[str, int]:
        if self.side != "program":
            return {}
        return {name: len(t.samples_ms) for name, t in self.system.stats.timers.items()}

    def program_record(self):
        """The controller's own stage timers (CUDA events): their samples
        since set-up or the last call."""
        if self.side != "program":
            return {}
        record = {"stage_ms": {name: list(t.samples_ms[self.stage_mark.get(name, 0):])
                               for name, t in self.system.stats.timers.items()}}
        self.stage_mark = self._stage_counts()
        return record

    def release(self) -> None:
        self.system = None

    def check(self, reference_device) -> Gaps:
        eng_r, _, _, _ = ref_modules()
        ref = self._reference(reference_device, torch.float64)
        per_mpc = ref.cfg.ticks_per_mpc
        gaps = Gaps()
        for u in self.sample.units():
            if u["k"] == 0:
                state = ref.reset_state(u["qpos"], u["qvel"])
            else:
                state = to_tuple(eng_r.EngineState, u["before"], reference_device)
            new, log, sol = ref.step_from(state, u["t"], u["qpos"], u["qvel"])
            after = u["after"]
            gaps.add("tau_Nm", torch.as_tensor(u["tau"])[None], log.tau)
            gaps.add("force_N", u["forces"], log.forces)
            if u["t"] % per_mpc == 0:
                gaps.add("mpc_u0_N", after.u0, new.u0)
                gaps.add("mpc_plan_N", after.U_warm, new.U_warm)
            gaps.add("state", flat_state(after), flat_state(new))
            gaps.add("next_q", after.q, new.q)
            gaps.add("next_v", after.v, new.v)
            gaps.add("clock_s", torch.stack([after.t, after.gait_clock], dim=-1),
                     torch.stack([new.t, new.gait_clock], dim=-1))
        return gaps


DRIVER = BridgeDriver
