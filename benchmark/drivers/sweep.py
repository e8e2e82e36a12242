"""A domain-randomized batch of whole control periods:
``parallel/sweep.run_sweep`` one period a call (configurations with
``"driver": "sweep"``).

Each call runs one period of every scenario from the last call's state;
episodes start standing (``engine/tick.init_state``) and last
``episode_units`` periods; the scenarios' parameters are drawn once per run.

The check: for the window's first period (from the reference's own
standing start) and ``check_units['period']`` periods drawn from the seed
(from the program's state), the plain reference runs the same period for every
scenario at float64 and the outputs are compared: the MPC's forces and
plan, the state after the period's 40 ticks and the period's statistics.
"""

from __future__ import annotations


import torch
from torch.profiler import record_function

from benchmark.harness import scenario as sc
from benchmark.harness.base import (Driver, engine_config, flat_state, ref_modules,
                                    scenario_of, to_tuple)
from benchmark.harness.compare import Gaps


class RefSweep:
    """The reference's side: one period of every scenario, the statistics
    of ``run_sweep`` worked out from the period's log."""

    def __init__(self, model, cfg, params):
        eng_r, _, _, _ = ref_modules()
        self.eng, self.model, self.cfg, self.params = eng_r, model, cfg, params
        self.loop = eng_r.ControlLoop(model, cfg)

    def init_state(self, batch: int, dtype):
        return self.eng.init_state(self.model, self.cfg, batch, dtype)

    def period(self, state):
        state, log = self.loop.period(state, self.params)
        return state, log.com[:, 0], log.com[..., 2].amin(dim=1), log.tau.abs().amax()


class SweepDriver(Driver):
    def _build(self) -> None:
        if self.side == "program":
            from g1_locomotion_tpu_torch.engine import tick as eng
            from g1_locomotion_tpu_torch.models.robot import load_robot
            from g1_locomotion_tpu_torch.parallel import sweep

            self.model = load_robot(self.config["robot"], device=self.device, dtype=self.dtype)
            self.cfg = engine_config(eng, self.config)
            self.loop = eng.ControlLoop(self.model, self.cfg)
            self.params = sc.apply_draws(scenario_of(eng, self.config, self.device, self.dtype),
                                         self.traffic, self.draws)
            self._init = lambda: eng.init_state(self.model, self.cfg, self.batch, self.dtype)
            self._run = lambda state: sweep.run_sweep(self.loop, self.params, 1, states0=state)
        else:
            ref = self._reference(self.device, self.dtype)
            self.cfg = ref.cfg
            self._init = lambda: ref.init_state(self.batch, self.dtype)

            def run(state):
                state, com_start, min_z, tau_max = ref.period(state)
                return state, (com_start, min_z), tau_max
            self._run = run
        self.ticks_per_unit = self.cfg.ticks_per_mpc

    def _reference(self, device, dtype) -> RefSweep:
        eng_r, _, rb_r, _ = ref_modules()
        model = rb_r.load_robot(self.config["robot"], device=device, dtype=dtype)
        params = sc.apply_draws(scenario_of(eng_r, self.config, device, dtype),
                                self.traffic, self.draws)
        return RefSweep(model, engine_config(eng_r, self.config), params)

    def _start_episode(self, episode) -> None:
        with record_function("bench.reset"):
            self.state = self._init()

    def _warm_up(self) -> None:
        self._start_episode(self.episodes[0])
        self.step()
        self.sync()

    def _step(self, unit) -> None:
        unit["before"] = self.state
        with record_function("bench.run_sweep"):
            self.state, (com_start, min_z), stats = self._run(self.state)
        tau_max = stats.tau_max if hasattr(stats, "tau_max") else stats
        unit.update(after=self.state, com_start=com_start, min_z=min_z, tau_max=tau_max)

    def release(self) -> None:
        self.loop = self.params = self._run = self._init = None

    def check(self, reference_device) -> Gaps:
        eng_r, _, _, _ = ref_modules()
        ref = self._reference(reference_device, torch.float64)
        gaps = Gaps()
        for u in self.sample.units():
            if u["k"] == 0:
                state = ref.init_state(self.batch, torch.float64)
            else:
                state = to_tuple(eng_r.EngineState, u["before"], reference_device)
            new, com_start, min_z, tau_max = ref.period(state)
            after = u["after"]
            gaps.add("mpc_u0_N", after.u0, new.u0)
            gaps.add("mpc_plan_N", after.U_warm, new.U_warm)
            gaps.add("state", flat_state(after), flat_state(new))
            gaps.add("next_q", after.q, new.q)
            gaps.add("next_v", after.v, new.v)
            gaps.add("clock_s", torch.stack([after.t, after.gait_clock], dim=-1),
                     torch.stack([new.t, new.gait_clock], dim=-1))
            gaps.add("com_start_m", u["com_start"], com_start)
            gaps.add("min_z_m", u["min_z"][:, None], min_z[:, None])
            gaps.add("tau_max_Nm", u["tau_max"].reshape(1), tau_max.reshape(1))
        return gaps


DRIVER = SweepDriver
