"""Whole-body contact plant: constrained forward dynamics, batched.

Port of ``g1_locomotion_tpu/engine/plant.py``: the physics stand-in for
MuJoCo. Torque-driven floating-base forward dynamics with the gait's active
contact points pinned by bilateral position constraints (a heel + toe pair
is the foot's line contact), one KKT system per instance and tick:

    [ M    J_a' ] [  a ]   [ S tau - h                  ]
    [ J_a  -eps ] [ -f ] = [ -Jdot v - stabilization    ]

with Baumgarte stabilization of the contact points' drift. Inactive
contacts are masked to identity rows (f = 0), so the shapes stay fixed.

The KKT matrix is indefinite: it is solved by LU (``torch.linalg.solve``),
as the reference solves it with ``jnp.linalg.solve`` outside any Pallas
kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from benchmark.reference.g1ref.models import dynamics as dyn
from benchmark.reference.g1ref.models import robot as rb
from benchmark.reference.g1ref.models.robot import RobotModel
from benchmark.reference.g1ref.wbid.stack import StackIndices, _frames_drift

NCP = 4  # contact points (L-heel, L-toe, R-heel, R-toe)


class PlantConfig(NamedTuple):
    dt: float = 0.001
    baumgarte_freq: float = 40.0  # rad/s of the stabilization dynamics
    kkt_reg: float = 1e-9


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (M @ x[..., None])[..., 0]


def constrained_step(
    model: RobotModel,
    idx: StackIndices,
    cfg: PlantConfig,
    q: torch.Tensor,        # (B, nq)
    v: torch.Tensor,        # (B, nv)
    tau: torch.Tensor,      # (B, nj) actuated torques (clipped to the limits here)
    active: torch.Tensor,   # (B, NCP) 0/1 contact flags
    anchors: torch.Tensor,  # (B, NCP, 3) world pin positions
    body_X=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One 1 kHz physics tick: (q_next (B, nq), v_next (B, nv), contact
    forces (B, NCP, 3))."""
    B, nv = q.shape[0], model.nv
    tau = torch.clamp(tau, min=-model.tau_max, max=model.tau_max)
    if body_X is None:
        body_X = rb.fk(model, q)

    M = dyn.crba(model, q, body_X)
    h = dyn.bias_force(model, q, v, body_X=body_X)
    S_tau = torch.cat([tau.new_zeros((B, 6)), tau], dim=-1)

    # Per-contact Jacobians, drifts (one forward pass), position errors.
    w = 2.0 * cfg.baumgarte_freq
    w2 = cfg.baumgarte_freq**2
    drifts = _frames_drift(model, q, v, idx.contacts, rows=slice(0, 3))  # (B, 12)
    Js, rhs_c = [], []
    for i, f in enumerate(idx.contacts):
        Jp = rb.frame_jacobian(model, q, body_X, f)[:, :3]
        e = rb.frame_pose(model, body_X, f).p - anchors[:, i]
        rhs_c.append(-(drifts[:, 3 * i:3 * i + 3] + w * _mv(Jp, v) + w2 * e))
        Js.append(Jp)
    J = torch.cat(Js, dim=-2)      # (B, 12, nv)
    b_c = torch.cat(rhs_c, dim=-1)  # (B, 12)

    mask = active.repeat_interleave(3, dim=-1)  # (B, 12)
    J_m = J * mask[..., None]
    b_m = b_c * mask

    # Inactive rows become lambda_i = 0; active rows get a small relaxation
    # that must clear the dtype's resolution: the heel + toe pin pairs make
    # the active block near-redundant, and below float32 resolution the LU
    # goes singular mid-rollout (NaN q around tick 15 of a float32 stand in
    # the reference).
    reg = cfg.kkt_reg if q.dtype == torch.float64 else max(cfg.kkt_reg, 1e-5)
    diag = torch.where(mask > 0.5, torch.full_like(mask, -reg), torch.full_like(mask, -1.0))
    K = torch.cat([torch.cat([M, J_m.mT], dim=-1),
                   torch.cat([J_m, torch.diag_embed(diag)], dim=-1)], dim=-2)
    rhs = torch.cat([S_tau - h, b_m], dim=-1)

    sol = torch.linalg.solve_ex(K, rhs[..., None]).result[..., 0]
    a = sol[:, :nv]
    # Row convention [J_m, -eps] [a; lam] = b with lam = -f.
    forces = (-sol[:, nv:]).reshape(B, NCP, 3) * active[..., None]

    v_next = v + cfg.dt * a
    # A toppled instance stays finite (a sweep reports it as fallen).
    v_next = torch.clamp(v_next, -100.0, 100.0)
    q_next = rb.integrate_q(model, q, v_next, cfg.dt)
    return q_next, v_next, forces


def anchors_from_state(model: RobotModel, idx: StackIndices, q: torch.Tensor) -> torch.Tensor:
    """(B, NCP, 3) contact-point positions at q."""
    body_X = rb.fk(model, q)
    return torch.stack([rb.frame_pose(model, body_X, f).p for f in idx.contacts], dim=1)
