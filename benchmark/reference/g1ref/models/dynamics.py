"""Batched whole-body dynamics: RNEA, CRBA, bias forces.

Port of ``g1_locomotion_tpu/models/dynamics.py`` (its production path, the
world-frame masked formulation), batch-first: ``q (B, nq)``, ``v``, ``a``
``(B, nv)``; torques ``(B, nv)``, mass matrices ``(B, nv, nv)``.

Every joint's unit twist is expressed in world Pluecker coordinates (moment
about the world origin, linear first). Body twists and accelerations are
ancestor-mask products over the joint twists, composite inertias mask
products over the per-body world spatial inertias, and torques the
transposed mask product of the body forces: a handful of batched products
instead of a sequential pass per body.

The reference's sequential implementations (``_rnea_unrolled``,
``_crba_unrolled``) are its own test oracle and are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from benchmark.reference.g1ref._device import const
from benchmark.reference.g1ref.core import rotations as rot
from benchmark.reference.g1ref.core.spatial import (
    SpatialInertia,
    Transform,
    motion_cross,
    motion_cross_force,
    spatial_inertia_from_params,
)
from benchmark.reference.g1ref.models.robot import RobotModel, _joint_world_geometry, fk

GRAVITY = 9.80665  # m/s^2, the value the reference publishes (ros_run_simulation.py:58)


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (M @ x[..., None])[..., 0]


def _base_plucker(body_X: Transform) -> torch.Tensor:
    """(B, 6, 6) motion transform taking base-local twists [v, w] to world
    Pluecker coordinates: v_O = R0 v + p0 x (R0 w), w_w = R0 w."""
    R0, p0 = body_X.R[:, 0], body_X.p[:, 0]
    top = torch.cat([R0, rot.skew(p0) @ R0], dim=-1)
    bot = torch.cat([torch.zeros_like(R0), R0], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _joint_plucker(model: RobotModel, body_X: Transform) -> torch.Tensor:
    """(B, nj, 6) unit twist of every joint in world Pluecker coordinates:
    S_j = [o_j x a_j, a_j] (axis a through point o)."""
    axis_w, origin_w = _joint_world_geometry(model, body_X)
    return torch.cat([torch.linalg.cross(origin_w, axis_w, dim=-1), axis_w], dim=-1)


def _world_inertias(model: RobotModel, body_X: Transform) -> SpatialInertia:
    """Per-body spatial inertia about the world origin, world axes (B, nb, ...)."""
    com_w = _mv(body_X.R, model.com) + body_X.p
    I_com_w = body_X.R @ model.inertia @ body_X.R.mT
    return spatial_inertia_from_params(model.mass.expand(com_w.shape[:-1]), com_w, I_com_w)


def rnea(model: RobotModel, q: torch.Tensor, v: torch.Tensor, a: torch.Tensor,
         gravity: float = GRAVITY, body_X: Optional[Transform] = None) -> torch.Tensor:
    """Inverse dynamics (B, nv): tau[:, 0:6] is the base wrench (linear
    first, base frame), tau[:, 6:] the joint torques. The caller subtracts
    Jc' f per contact for actuated torques (reference wbid.py:320).

    Body twists are ``B v_base + mask @ (S qd)``; accelerations unroll the
    Featherstone recursion the same way (the S-dot term uses the child body's
    twist, exact since (S qd) x S = 0); generalized forces are the
    transposed-mask contraction of the per-body net forces. Pass ``body_X``
    (fk's output) to reuse the tick's FK.
    """
    if body_X is None:
        body_X = fk(model, q)
    Bp = _base_plucker(body_X)
    S = _joint_plucker(model, body_X)  # (B, nj, 6)
    AM = model.ancestor  # (nb, nj)

    qd, qdd = v[:, 6:], a[:, 6:]
    Sqd = S * qd[..., None]
    tw = _mv(Bp, v[:, 0:6])[:, None, :] + AM @ Sqd  # (B, nb, 6) world body twists

    # Gravity trick: the root accelerates upward at g (a uniform translation,
    # moment-free).
    a_grav = const((0.0, 0.0, float(gravity), 0.0, 0.0, 0.0), q)  # no host copy per call
    Sdot_qd = motion_cross(tw[:, 1:], Sqd)  # (B, nj, 6): v_child x S qd
    A = (a_grav + _mv(Bp, a[:, 0:6]))[:, None, :] + AM @ (S * qdd[..., None] + Sdot_qd)

    Iw = _world_inertias(model, body_X)
    F = Iw.apply(A) + motion_cross_force(tw, Iw.apply(tw))  # (B, nb, 6)

    tau_j = torch.sum((AM.mT @ F) * S, dim=-1)  # subtree force . joint twist
    tau_base = _mv(Bp.mT, torch.sum(F, dim=-2))  # total wrench, base-local
    return torch.cat([tau_base, tau_j], dim=-1)


def bias_force(model: RobotModel, q: torch.Tensor, v: torch.Tensor,
               gravity: float = GRAVITY, body_X: Optional[Transform] = None) -> torch.Tensor:
    """h(q, v) = C(q, v) v + g(q), the nonlinear-effects vector (B, nv)."""
    return rnea(model, q, v, torch.zeros_like(v), gravity, body_X)


def gravity_force(model: RobotModel, q: torch.Tensor, gravity: float = GRAVITY,
                  body_X: Optional[Transform] = None) -> torch.Tensor:
    z = q.new_zeros((q.shape[0], model.nv))
    return rnea(model, q, z, z, gravity, body_X)


def crba(model: RobotModel, q: torch.Tensor, body_X: Optional[Transform] = None) -> torch.Tensor:
    """Joint-space mass matrix M (B, nv, nv) by the Composite Rigid Body
    Algorithm: [[M_base (6x6), M_bj], [M_bj', M_jj]], the base block in the
    base frame, linear first, so that rnea(q, 0, a) = M a + g(q).

    The composite inertia of every joint is one mask product over the world
    spatial inertias; M[i, j] = S_i . (Ic_j S_j) for i ancestor-or-self of j
    is one (nj, nj) Gram matrix masked by the joints' ancestry."""
    if body_X is None:
        body_X = fk(model, q)
    Bp = _base_plucker(body_X)
    S = _joint_plucker(model, body_X)  # (B, nj, 6)
    AM = model.ancestor  # (nb, nj)

    I6 = _world_inertias(model, body_X).to_matrix()  # (B, nb, 6, 6)
    Ic = torch.einsum("bj,Bbkl->Bjkl", AM, I6)  # (B, nj, 6, 6) subtree inertias
    Fc = _mv(Ic, S)  # (B, nj, 6)

    G = S @ Fc.mT  # G[i, j] = S_i . Ic_j S_j
    JJ = AM[1:, :]  # JJ[j, i] = 1 iff joint i is an ancestor-or-self of joint j
    Mjj_u = G * JJ.mT
    Mjj = Mjj_u + Mjj_u.mT - torch.diag_embed(torch.diagonal(Mjj_u, dim1=-2, dim2=-1))

    Mbj = Bp.mT @ Fc.mT  # (B, 6, nj) base coupling
    M00 = Bp.mT @ torch.sum(I6, dim=-3) @ Bp  # whole-robot inertia, base coordinates

    top = torch.cat([M00, Mbj], dim=-1)
    bot = torch.cat([Mbj.mT, Mjj], dim=-1)
    return torch.cat([top, bot], dim=-2)


def forward_dynamics(model: RobotModel, q: torch.Tensor, v: torch.Tensor, tau: torch.Tensor,
                     gravity: float = GRAVITY,
                     body_X: Optional[Transform] = None) -> torch.Tensor:
    """a = M^-1 (tau - h) (B, nv), a dense solve."""
    if body_X is None:
        body_X = fk(model, q)
    M = crba(model, q, body_X)
    h = bias_force(model, q, v, gravity, body_X)
    return torch.linalg.solve(M, tau - h)
