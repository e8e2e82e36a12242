"""SRBD-level closed loop: the planner and the MPC drive the single rigid
body they model.

Port of ``g1_locomotion_tpu/mpc/srbd_loop.py``, batch-first. The planner
(:mod:`..gait.planner`) and the SRBD MPC (:mod:`.solver`) close the loop one
level below the whole-body engine: the body integrates the MPC's first-step
forces with the MPC's own ZOH discretization, and at touchdown a foot
teleports to the planned landing (perfect swing tracking). A gait that falls
here has a planning or MPC fault; one that walks here but falls in the
engine has a tracking fault. The reference module documents the rest.

:class:`SRBDLoop` is an ``nn.Module`` like ``engine.tick.ControlLoop``:
:meth:`SRBDLoop.period` runs one period for a batch of instances (every
state field ``(B, ...)``), :meth:`SRBDLoop.rollout` repeats it. The
touchdown FSM and the force mask are ``torch.where`` / products per
instance: a period makes no host sync and takes no Python branch on data.
Which kernels it launches follows from ``cfg.qp``, as for the MPC solve.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from benchmark.reference.g1ref._device import const, require_cuda
from benchmark.reference.g1ref.gait import planner
from benchmark.reference.g1ref.gait import schedule as gs
from benchmark.reference.g1ref.models import srbd
from benchmark.reference.g1ref.mpc import solver as mpc


class SRBDLoopState(NamedTuple):
    x: torch.Tensor            # (B, 13) SRBD state
    feet: torch.Tensor         # (B, 2, 3) foot centers (L, R)
    U_warm: torch.Tensor       # (B, N, 12)
    gait_clock: torch.Tensor   # (B,)
    prev_stance: torch.Tensor  # (B, 2) contact flags of the previous period
    landing: torch.Tensor      # (B, 3) latest planned touchdown point


class SRBDLoopLog(NamedTuple):
    """One period's log, (B, ...); a rollout stacks them to (B, n_periods, ...)."""

    x: torch.Tensor        # (B, 13) realized state at the period's end
    plan_x1: torch.Tensor  # (B, 13) the MPC's one-period prediction
    u0: torch.Tensor       # (B, 12)
    landing: torch.Tensor  # (B, 3)
    feet: torch.Tensor     # (B, 2, 3)
    contact: torch.Tensor  # (B, 2) per-foot flags
    d: torch.Tensor        # (B, 2) footstep-QP offset
    pri_res: torch.Tensor  # (B,)


def init_loop_state(cfg: mpc.MPCConfig, com_height: float, *, batch: int = 1, device=None,
                    dtype=torch.float64, stance_width: float = 0.1185,
                    foot_x: float = 0.0557) -> SRBDLoopState:
    """The standing start of the whole-body engine's geometry
    (``engine/state.q_init_standing``: feet at x = 0.0557, y = +-0.1185),
    (batch, ...); ``device=None`` takes the card."""
    device = require_cuda() if device is None else device
    x = torch.zeros(13, dtype=dtype, device=device)
    x[5] = com_height
    x[12] = srbd.GRAVITY
    x[3] = foot_x
    feet = torch.tensor([[foot_x, stance_width, 0.0], [foot_x, -stance_width, 0.0]],
                        dtype=dtype, device=device)
    return SRBDLoopState(
        x=x.expand(batch, 13).clone(), feet=feet.expand(batch, 2, 3).clone(),
        U_warm=torch.zeros((batch, cfg.horizon, 12), dtype=dtype, device=device),
        gait_clock=torch.zeros(batch, dtype=dtype, device=device),
        prev_stance=torch.ones((batch, 2), dtype=dtype, device=device),
        landing=feet[0].expand(batch, 3).clone(),
    )


def contacts_from_feet(feet: torch.Tensor) -> torch.Tensor:
    """(B, 2, 3) foot centers -> (B, 4, 3) heel / toe contact points."""
    ht = const(planner.HEEL_TOE_XY, feet)
    return torch.cat([feet[:, 0:1] + ht, feet[:, 1:2] + ht], dim=1)


class SRBDLoop(nn.Module):
    """The closed loop of planner, MPC and rigid body as a module.

    ``sim_params``: the *simulated* rigid body (by default the MPC's own
    ``params.srbd``; give another mass / inertia for model-mismatch
    studies), kept as buffers."""

    def __init__(self, cfg: mpc.MPCConfig, com_height: float = 0.598, subdivide: int = 1,
                 sim_params: Optional[srbd.SRBDParams] = None):
        super().__init__()
        self.cfg, self.com_height, self.subdivide = cfg, com_height, subdivide
        if sim_params is None:
            self.sim_mass = self.sim_inertia = None
        else:
            self.register_buffer("sim_mass", torch.as_tensor(sim_params.mass))
            self.register_buffer("sim_inertia", torch.as_tensor(sim_params.inertia))

    def period(self, state: SRBDLoopState, params, kick: Optional[torch.Tensor] = None
               ) -> Tuple[SRBDLoopState, SRBDLoopLog]:
        """One MPC period; ``params`` an ``engine.tick.ScenarioParams`` (its
        srbd, mpc_weights, gait, steps, v_cmd), ``kick`` (B, 3) a velocity
        impulse added at the period's end, or None."""
        cfg = self.cfg
        sp = params.srbd if self.sim_mass is None else srbd.SRBDParams(
            mass=self.sim_mass, inertia=self.sim_inertia)

        cpos = contacts_from_feet(state.feet)
        plan = planner.plan_horizon(
            params.gait, params.steps, params.v_cmd, state.x, cpos, state.gait_clock,
            cfg.horizon, cfg.dt, self.com_height)
        sol = mpc.solve(cfg, params.mpc_weights, params.srbd, state.x, plan.x_ref,
                        plan.contact_hor, plan.c_hor, plan.p_ref, U_warm=state.U_warm,
                        landing_mask=plan.landing_mask, hdot_sw=plan.hdot_geom)
        landing = plan.landing
        if cfg.footstep_opt:
            landing = planner.apply_landing_offset(plan, sol.d)

        # Integrate the simulated SRBD under the first-step forces (ZOH).
        r = cpos - state.x[:, None, 3:6]
        A_c, B_c = srbd.continuous_matrices(sp, state.x[:, 2], r)
        # Inactive contacts carry (QP-enforced) zero force; mask anyway so
        # model mismatch cannot leak force through them.
        foot_on = torch.stack([plan.contact_hor[:, 0, 0], plan.contact_hor[:, 0, 2]], dim=-1)
        f = sol.u0 * foot_on.repeat_interleave(2, dim=-1).repeat_interleave(3, dim=-1)
        Ad, Bd = srbd.discretize(A_c, B_c, cfg.dt / self.subdivide)
        x = state.x
        for _ in range(self.subdivide):
            x = (Ad @ x[..., None] + Bd @ f[..., None])[..., 0]
        if kick is not None:
            x = torch.cat([x[:, :9], x[:, 9:12] + kick, x[:, 12:]], dim=-1)

        # Touchdown FSM: a foot returning to stance teleports to the planned
        # landing, keeping its height.
        clock_new = state.gait_clock + cfg.dt
        flags = gs.contact_flags(params.gait, clock_new)
        stance = torch.stack([flags[:, 0], flags[:, 2]], dim=-1)
        touchdown = (stance > 0.5) & (state.prev_stance < 0.5)
        landing_xy = torch.cat([landing[:, None, :2].expand(-1, 2, 2), state.feet[..., 2:]],
                               dim=-1)
        feet = torch.where(touchdown[..., None], landing_xy, state.feet)

        log = SRBDLoopLog(x=x, plan_x1=sol.x_horizon[:, 1], u0=sol.u0, landing=landing,
                          feet=feet, contact=stance, d=sol.d, pri_res=sol.pri_res)
        return SRBDLoopState(x=x, feet=feet, U_warm=sol.U, gait_clock=clock_new,
                             prev_stance=stance, landing=landing), log

    def rollout(self, state: SRBDLoopState, params, n_periods: int,
                kicks: Optional[torch.Tensor] = None) -> Tuple[SRBDLoopState, SRBDLoopLog]:
        """``n_periods`` periods, ``kicks`` (B, n_periods, 3) or None: (the
        final state, the log (B, n_periods, ...))."""
        logs: List[SRBDLoopLog] = []
        for k in range(n_periods):
            state, log = self.period(state, params, None if kicks is None else kicks[:, k])
            logs.append(log)
        return state, SRBDLoopLog(*(torch.stack(f, dim=1) for f in zip(*logs)))


def make_srbd_loop(cfg: mpc.MPCConfig, com_height: float = 0.598, subdivide: int = 1,
                   sim_params: Optional[srbd.SRBDParams] = None):
    """The reference's factory: the rollout ``(state, params, n_periods,
    kicks=None) -> (state, log)`` of an :class:`SRBDLoop`."""
    return SRBDLoop(cfg, com_height, subdivide, sim_params).rollout
