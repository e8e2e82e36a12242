"""A batched SRBD-MPC gait sweep: ``mpc/srbd_loop.SRBDLoop.period`` over a
batch of instances (configurations with ``"driver": "srbd_loop"``).

Episodes start standing (``init_loop_state``) and last ``episode_units``
periods; each instance has its own drawn gait, command and mass, and a
drawn lateral velocity kick at the period ``kick['period']`` of every
episode. The loop takes no friction per instance (its MPC's mu is the
configuration's), so its mix draws none.

The check: for the window's first period (from the reference's own
standing start) and a sample drawn from the seed of the window's kick
periods and of its other periods (``check_units['kick']`` and
``check_units['period']``, from the program's state), the plain reference
runs the same period for every instance at float64 and the outputs are
compared: the MPC's first forces and plan, the integrated body state, the
feet and the planned landing.
"""

from __future__ import annotations


import torch
from torch.profiler import record_function

from benchmark.harness import scenario as sc
from benchmark.harness.base import Driver, flat_state, ref_modules, scenario_of, to_tuple
from benchmark.harness.compare import Gaps


def build_mpc(mpc_module, config: dict):
    return sc.apply_overrides(mpc_module.MPCConfig(), config.get("mpc", {}))


class SRBDDriver(Driver):
    def _build(self) -> None:
        com_height = float(self.config["com_height"])
        if self.side == "program":
            from g1_locomotion_tpu_torch.engine import tick as eng
            from g1_locomotion_tpu_torch.mpc import solver as mpc
            from g1_locomotion_tpu_torch.mpc import srbd_loop
        else:
            from benchmark.reference.g1ref.engine import tick as eng
            from benchmark.reference.g1ref.mpc import solver as mpc
            from benchmark.reference.g1ref.mpc import srbd_loop
        cfg = build_mpc(mpc, self.config)
        self.loop = srbd_loop.SRBDLoop(cfg, com_height)
        self.params = sc.apply_draws(scenario_of(eng, self.config, self.device, self.dtype),
                                     self.traffic, self.draws)
        self._init = lambda: srbd_loop.init_loop_state(cfg, com_height, batch=self.batch,
                                                       device=self.device, dtype=self.dtype)
        self.kick_at = int(self.traffic["kick"]["period"])

    def _reference(self, device):
        from benchmark.reference.g1ref.engine import tick as eng
        from benchmark.reference.g1ref.mpc import solver as mpc
        from benchmark.reference.g1ref.mpc import srbd_loop

        com_height = float(self.config["com_height"])
        cfg = build_mpc(mpc, self.config)
        params = sc.apply_draws(scenario_of(eng, self.config, device, torch.float64),
                                self.traffic, self.draws)
        init = lambda: srbd_loop.init_loop_state(cfg, com_height, batch=self.batch,
                                                 device=device, dtype=torch.float64)
        return srbd_loop.SRBDLoop(cfg, com_height), params, init

    def _kick(self, episode) -> torch.Tensor:
        """(B, 3): the episode's lateral kick [m/s]."""
        kick = torch.zeros((self.batch, 3), dtype=self.dtype, device=self.device)
        kick[:, 1] = episode["kick"].to(self.device)
        return kick

    def _start_episode(self, episode) -> None:
        with record_function("bench.reset"):
            self.state = self._init()
            self.kick = self._kick(episode)

    def _warm_up(self) -> None:
        # One period without and one with the kick: both shapes of the step.
        self._start_episode(self.episodes[0])
        self.step()
        self.k = self.kick_at
        self.step()
        self.sync()

    def _step(self, unit) -> None:
        kick = self.kick if self.k == self.kick_at else None
        unit.update(before=self.state, kick=kick)
        with record_function("bench.period"):
            self.state, log = self.loop.period(self.state, self.params, kick)
        unit.update(after=self.state, u0=log.u0)

    def _stratum(self, unit) -> str:
        return "period" if unit["kick"] is None else "kick"

    def release(self) -> None:
        self.loop = self.params = self._init = None

    def check(self, reference_device) -> Gaps:
        _, _, _, srbd_r = ref_modules()
        loop, params, init = self._reference(reference_device)
        gaps = Gaps()
        for u in self.sample.units():
            state = init() if u["k"] == 0 else to_tuple(srbd_r.SRBDLoopState, u["before"],
                                                        reference_device)
            kick = None if u["kick"] is None else u["kick"].to(reference_device, torch.float64)
            new, log = loop.period(state, params, kick)
            after = u["after"]
            gaps.add("mpc_u0_N", u["u0"], log.u0)
            gaps.add("mpc_plan_N", after.U_warm, new.U_warm)
            gaps.add("state", flat_state(after), flat_state(new))
            gaps.add("body_x", after.x, new.x)
            gaps.add("feet_m", after.feet, new.feet)
            gaps.add("landing_m", after.landing, new.landing)
            gaps.add("clock_s", after.gait_clock[:, None], new.gait_clock[:, None])
        return gaps


DRIVER = SRBDDriver
