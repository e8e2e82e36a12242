"""WBID stack compiler: tasks and constraints -> dense QP blocks, batched.

Port of ``g1_locomotion_tpu/wbid/stack.py``, batch-first. Each task
contributes a weighted least-squares block ``(A_i, b_i, w_i)``, each
constraint rows ``(C_j, l_j, u_j)``; the assembled QP

    min_x  sum_i w_i ||A_i x - b_i||^2     s.t.  l <= C x <= u
    x = [qddot (nv), f (4 contacts x 3)]

is solved by the shared batched ADMM (:mod:`benchmark.reference.g1ref.ops.qp`).
Every block carries the batch axis in front: ``H (B, nx, nx)``,
``C (B, m, nx)``, ``l`` and ``u`` ``(B, m)``.

Task switching (stance <-> swing) masks weights and bounds with static
shapes, as the reference's ``setActive`` / ``setWrenchLimits`` do
imperatively (ros_run_simulation.py:230-244). Drift terms (Jdot v) are the
forward-mode derivative of the frame / CoM velocities along the current
motion (``torch.func.jvp`` along a 0-d time ``t``).

Everything that depends on the model alone (the leg joints, the selectors,
the friction-cone templates) is built once per model and device, on
:class:`StackIndices`; a call copies nothing from the host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from benchmark.reference.g1ref.core.rotations import skew
from benchmark.reference.g1ref.models import dynamics as dyn
from benchmark.reference.g1ref.models import robot as rb
from benchmark.reference.g1ref.models.robot import RobotModel
from benchmark.reference.g1ref.wbid.tasks import WBIDGains, WBIDReferences

# Contact frames, in the reference's order (wbid.py:39-44).
CONTACT_FRAMES = (
    "left_foot_line_contact_lower",
    "left_foot_line_contact_upper",
    "right_foot_line_contact_lower",
    "right_foot_line_contact_upper",
)
FOOT_FRAMES = ("left_foot_point_contact", "right_foot_point_contact")
HAND_FRAMES = ("left_hand_point_contact", "right_hand_point_contact")
NF = 4  # contact force variables
NX_F = 3 * NF
CONTACT_FOOT = tuple(i // 2 for i in range(NF))  # the foot each contact belongs to
BIG = 1e20  # sentinel for an unbounded side


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (M @ x[..., None])[..., 0]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def leg_joints(model: RobotModel) -> Tuple[int, ...]:
    """The joints on the paths from the base to the feet (empty for a
    variant without feet), from the tree rather than from joint names."""
    legs = set()
    for name in FOOT_FRAMES:
        if name in model.frame_names:
            row = model.ancestor_mask[model.frame_body[model.frame_index(name)]]
            legs.update(j for j, on in enumerate(row) if on)
    return tuple(sorted(legs))


@dataclasses.dataclass(frozen=True)
class StackIndices:
    """Frame and joint indices of the stack, resolved once per model, and
    the constant blocks built from them on the model's device and dtype."""

    contacts: Tuple[int, ...]
    feet: Tuple[int, ...]
    pelvis: int
    hands: Tuple[int, ...]  # hand point contacts (empty without hands)
    torso: int              # torso_link (-1 without one)
    legs: Tuple[int, ...]   # leg joints (leg_joints)
    knees: Tuple[int, ...]  # the leg joints named as knees (the knee floor's)
    posture: Tuple[int, ...]  # the other joints: the postural task's
    # Constant blocks (rows of the QP over x = [qddot, f]):
    posture_A: torch.Tensor   # (n_post, nx) selector of the postural joints
    posture_index: torch.Tensor  # (n_post,) long
    legs_A: torch.Tensor      # (n_leg, nx)
    legs_index: torch.Tensor  # (n_leg,) long
    knee_mask: torch.Tensor   # (nj,) bool
    qddot_A: torch.Tensor     # (nv, nx) [I, 0]
    joints_A: torch.Tensor    # (nj, nx) [0, I, 0]: the joint-limit rows
    wrench_A: torch.Tensor    # (NX_F, nx) [0, I]: the per-contact force rows
    total_force_A: torch.Tensor  # (3, nx) [0, I, I, I, I]: the net force
    cone_T0: torch.Tensor     # (NF, 5, nx) cone rows, the part without mu
    cone_Tmu: torch.Tensor    # (NF, 5, nx) cone rows, the coefficient of -mu
    cone_Teq: torch.Tensor    # (NF, 5, nx) swing rewrite: f = 0 equalities
    box_Txy: torch.Tensor     # (NF, 2, nx) tangential box rows
    contact_foot: torch.Tensor  # (NF,) long: CONTACT_FOOT

    @staticmethod
    def from_model(model: RobotModel) -> "StackIndices":
        nv, nj = model.nv, model.nj
        nx = nv + NX_F
        legs = leg_joints(model)
        posture = tuple(j for j in range(nj) if j not in legs)

        def sel(joints):
            a = np.zeros((len(joints), nx))
            a[np.arange(len(joints)), 6 + np.asarray(joints, dtype=np.int64)] = 1.0
            return a

        T0, Tmu, Teq, Txy = (np.zeros((NF, r, nx)) for r in (5, 5, 5, 2))
        for i in range(NF):
            c = nv + 3 * i
            T0[i, 0, c], T0[i, 1, c], T0[i, 2, c + 1], T0[i, 3, c + 1] = 1.0, -1.0, 1.0, -1.0
            T0[i, 4, c + 2] = 1.0
            Tmu[i, 0:4, c + 2] = 1.0
            Teq[i, 0, c], Teq[i, 1, c + 1], Teq[i, 2, c + 2] = 1.0, 1.0, 1.0
            Txy[i, 0, c], Txy[i, 1, c + 1] = 1.0, 1.0
        eye = np.eye(nx)

        def t(a, dtype=model.dtype):
            return torch.tensor(np.asarray(a), dtype=dtype, device=model.device)

        return StackIndices(
            contacts=tuple(model.frame_index(f) for f in CONTACT_FRAMES),
            feet=tuple(model.frame_index(f) for f in FOOT_FRAMES),
            pelvis=model.frame_index("pelvis"),
            hands=tuple(model.frame_index(f) for f in HAND_FRAMES if f in model.frame_names),
            torso=model.frame_index("torso_link") if "torso_link" in model.frame_names else -1,
            legs=legs,
            knees=tuple(j for j in legs if "knee" in model.joint_names[j]),
            posture=posture,
            posture_A=t(sel(posture)),
            posture_index=t(posture, torch.long),
            legs_A=t(sel(legs)),
            legs_index=t(legs, torch.long),
            knee_mask=t([j in legs and "knee" in model.joint_names[j] for j in range(nj)],
                        torch.bool),
            qddot_A=t(eye[:nv]),
            joints_A=t(eye[6:nv]),
            wrench_A=t(eye[nv:]),
            total_force_A=t(np.tile(np.eye(3), (1, NF)) @ eye[nv:]),
            cone_T0=t(T0),
            cone_Tmu=t(Tmu),
            cone_Teq=t(Teq),
            box_Txy=t(Txy),
            contact_foot=t(CONTACT_FOOT, torch.long),
        )


def _drift(f, q: torch.Tensor) -> torch.Tensor:
    """d/dt f(t) at t = 0 (forward mode)."""
    t = q.new_zeros(())
    return torch.func.jvp(f, (t,), (torch.ones_like(t),))[1]


def _frames_drift(model, q, v, fidxs, rows=slice(None)):
    """Jdot v of several frames (B, len(fidxs) * rows) in one forward pass."""

    def f(t):
        q_t = rb.integrate_q(model, q, v, t)
        X_t = rb.fk(model, q_t)
        return torch.cat([_mv(rb.frame_jacobian(model, q_t, X_t, fi), v)[:, rows]
                          for fi in fidxs], dim=-1)

    return _drift(f, q)


def _split_drifts(d: torch.Tensor):
    return d[:, 0:3], d[:, 3:9], d[:, 9:15], d[:, 15:21], d[:, 21:24]


def _all_task_drifts(model, q, v, idx):
    """Every task drift in one forward pass: (com (B, 3), base (B, 6),
    foot 0 (B, 6), foot 1 (B, 6), L-dot drift (B, 3))."""

    def f(t):
        q_t = rb.integrate_q(model, q, v, t)
        X_t = rb.fk(model, q_t)
        com_v = _mv(rb.com_jacobian(model, q_t, X_t), v)
        base6 = _mv(rb.frame_jacobian(model, q_t, X_t, idx.pelvis), v)
        f0 = _mv(rb.frame_jacobian(model, q_t, X_t, idx.feet[0]), v)
        f1 = _mv(rb.frame_jacobian(model, q_t, X_t, idx.feet[1]), v)
        L = angular_momentum(model, q_t, v, X_t)
        return torch.cat([com_v, base6, f0, f1, L], dim=-1)

    return _split_drifts(_drift(f, q))


def _all_task_drifts_fast(model, q, v, idx):
    """The same values as :func:`_all_task_drifts` with fewer operations:
    the frame velocities from the batched multi-frame Jacobian, the momentum
    as A_G(q) v (the serving path, ``WBIDConfig.fast_stack``)."""

    def f(t):
        q_t = rb.integrate_q(model, q, v, t)
        X_t = rb.fk(model, q_t)
        com_v = _mv(rb.com_jacobian(model, q_t, X_t), v)
        Js = rb.frame_jacobians(model, q_t, X_t, (idx.pelvis,) + tuple(idx.feet))
        vels = _mv(Js, v[:, None, :]).reshape(q.shape[0], -1)  # (B, 18)
        L = _mv(centroidal_momentum_matrix(model, q_t, X_t), v)
        return torch.cat([com_v, vels, L], dim=-1)

    return _split_drifts(_drift(f, q))


def angular_momentum(model: RobotModel, q, v, body_X) -> torch.Tensor:
    """Centroidal angular momentum L (B, 3) about the whole-body CoM."""
    return _angular_momentum_impl(model, q, v, body_X, rb.com_position(model, body_X))


def centroidal_momentum_matrix(model: RobotModel, q, body_X) -> torch.Tensor:
    """Angular part of the centroidal momentum matrix A_G (B, 3, nv): L = A_G v.

    Closed form: each body contributes I_b^w J_b^ang + m_b S(c_b - c)
    J_b^lin(com_b), from the shared joint world geometry and the ancestor
    mask."""
    R, p = body_X.R, body_X.p
    mask = model.ancestor  # (nb, nj)
    com_b = _mv(R, model.com) + p  # (B, nb, 3)
    com = torch.sum(model.mass[:, None] * com_b, dim=-2) / model.total_mass
    I_w = R @ model.inertia @ R.mT

    axis_w, origin_w = rb._joint_world_geometry(model, body_X)  # (B, nj, 3)
    # Joint columns: omega_b gains mask[b, j] a_j, v_com_b gains
    # mask[b, j] a_j x (com_b - o_j).
    d = com_b[:, :, None, :] - origin_w[:, None, :, :]  # (B, nb, nj, 3)
    lin = _cross(axis_w[:, None].expand_as(d), d)
    r = com_b - com[:, None, :]  # (B, nb, 3)
    Iw_axis = torch.einsum("Bbil,Bjl->Bbji", I_w, axis_w)  # I_w[b] a_j
    col_ang = torch.einsum("bj,Bbji->Bij", mask, Iw_axis)
    cross_r_lin = _cross(r[:, :, None, :].expand_as(lin), lin)
    col_lin = torch.einsum("b,bj,Bbji->Bij", model.mass, mask, cross_r_lin)
    A_joints = col_ang + col_lin  # (B, 3, nj)

    # Base columns: omega_b = R0 w_loc for every body, v_com_b = R0 v_loc +
    # (R0 w_loc) x (com_b - p0); the v_loc part sums to zero (sum m r = 0).
    R0 = R[:, 0]
    d0 = com_b - p[:, 0:1]
    A_w = torch.sum(I_w, dim=-3) @ R0 - torch.einsum(
        "b,Bbij,Bbjk->Bik", model.mass, skew(r), skew(d0)) @ R0
    return torch.cat([torch.zeros_like(R0), A_w, A_joints], dim=-1)


def _angular_momentum_impl(model, q, v, body_X, com):
    """L by propagating the body twists down the tree in world coordinates."""
    R, p = body_X.R, body_X.p
    v_lin = [_mv(R[:, 0], v[:, 0:3])]
    v_ang = [_mv(R[:, 0], v[:, 3:6])]
    for b in range(1, model.nb):
        pa = model.parent[b]
        axis_w = _mv(R[:, pa] @ model.joint_origin_R[b], model.joint_axis[b])
        origin_w = _mv(R[:, pa], model.joint_origin_p[b]) + p[:, pa]
        w_par = v_ang[pa]
        v_lin.append(v_lin[pa] + _cross(w_par, origin_w - p[:, pa]))  # = the body origin's
        v_ang.append(w_par + axis_w * v[:, 6 + b - 1, None])
    L = torch.zeros_like(com)
    for b in range(model.nb):
        Rb = R[:, b]
        com_b = _mv(Rb, model.com[b]) + p[:, b]
        I_w = Rb @ model.inertia[b] @ Rb.mT
        v_com_b = v_lin[b] + _cross(v_ang[b], com_b - p[:, b])
        L = L + _mv(I_w, v_ang[b]) + model.mass[b] * _cross(com_b - com, v_com_b)
    return L


def _rotation_error(R_des: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """so(3) orientation error e (..., 3) such that rotating by e aligns R
    to R_des (vee of the skew part of R_des R')."""
    E = R_des @ R.mT
    return 0.5 * torch.stack([E[..., 2, 1] - E[..., 1, 2], E[..., 0, 2] - E[..., 2, 0],
                              E[..., 1, 0] - E[..., 0, 1]], dim=-1)


def build_qp(model: RobotModel, idx: StackIndices, gains: WBIDGains, q: torch.Tensor,
             v: torch.Tensor, refs: WBIDReferences, dt: float, body_X=None,
             with_blocks: bool = False, fast: bool = False):
    """Assemble (H, g, C, l, u) of the WBID QP and the dynamics terms
    (M, h, Jc'), batched.

    ``body_X`` is the FK of q where the caller has it. ``fast`` takes the
    serving path's assembly: every frame Jacobian from one batched pass,
    the momentum from A_G, the cone rows in one block; the same QP.
    ``with_blocks`` also returns the task blocks ``(A_all, b_all, w_all,
    levels)`` for the strict-hierarchy solve (wbid/ihqp.py); ``levels`` is a
    numpy row tag (0 feet / contacts, 1 CoM / base / momentum / wrench,
    2 posture / regularization), the OpenSoT ``/`` convention."""
    B, dtype, device = q.shape[0], q.dtype, q.device
    nv = model.nv
    nx = nv + NX_F

    if body_X is None:
        body_X = rb.fk(model, q)
    M = dyn.crba(model, q, body_X)
    h = dyn.bias_force(model, q, v, body_X=body_X)

    if fast:
        frames = tuple(idx.contacts) + (idx.pelvis,) + tuple(idx.feet)
        J_all = rb.frame_jacobians(model, q, body_X, frames)  # (B, 7, 6, nv)
        Jc = [J_all[:, i, :3] for i in range(NF)]
        J_base = J_all[:, NF]
        J_feet = (J_all[:, NF + 1], J_all[:, NF + 2])
        drifts = _all_task_drifts_fast(model, q, v, idx)
    else:
        Jc = [rb.frame_jacobian(model, q, body_X, f)[:, :3] for f in idx.contacts]
        J_base = rb.frame_jacobian(model, q, body_X, idx.pelvis)
        J_feet = tuple(rb.frame_jacobian(model, q, body_X, f) for f in idx.feet)
        drifts = _all_task_drifts(model, q, v, idx)
    com_drift, base_drift6, foot_drift0, foot_drift1, L_drift = drifts
    foot_drifts = (foot_drift0, foot_drift1)

    A_blocks, b_blocks, w_blocks, lvl_blocks = [], [], [], []

    def add(A, b, w, level=1):
        """A (B, r, nx) or (r, nx); b (B, r); w broadcast to (B, r)."""
        rows = A.shape[-2]
        A_blocks.append(A.expand(B, rows, nx))
        b_blocks.append(b)
        w_blocks.append(torch.broadcast_to(w, (B, rows)).to(dtype))
        lvl_blocks.append([level] * rows)

    def with_forces(J):
        """[J, 0]: a task on qddot alone, over x = [qddot, f]."""
        return torch.cat([J, J.new_zeros(J.shape[:-1] + (NX_F,))], dim=-1)

    # --- CoM task (wbid.py:53-60,167) ---
    J_com = rb.com_jacobian(model, q, body_X)
    com = rb.com_position(model, body_X)
    a_des = (refs.com_acc + gains.com_kp * (refs.com_pos - com)
             + gains.com_kd * (refs.com_vel - _mv(J_com, v)))
    add(with_forces(J_com), a_des - com_drift, gains.w_com)

    # --- Base orientation task, rows 3:6 (wbid.py:67-75,172) ---
    base_w = _mv(J_base[:, 3:6], v)
    e_ang = _rotation_error(refs.base_R, body_X.R[:, 0])
    a_des = (refs.base_angacc + gains.base_kp_ang * e_ang
             + gains.base_kd_ang * (refs.base_angvel - base_w))
    add(with_forces(J_base[:, 3:6]), a_des - base_drift6[:, 3:6], gains.w_base)

    # --- Optional torso-orientation task (rows 3:6 on torso_link), only
    # with refs.torso_R ---
    if refs.torso_R is not None and idx.torso >= 0:
        J_torso = rb.frame_jacobian(model, q, body_X, idx.torso)
        torso_R = rb.frame_pose(model, body_X, idx.torso).R
        torso_drift = _frames_drift(model, q, v, (idx.torso,), rows=slice(3, 6))
        a_des_t = (gains.torso_kp_ang * _rotation_error(refs.torso_R, torso_R)
                   + gains.torso_kd_ang * (refs.base_angvel - _mv(J_torso[:, 3:6], v)))
        add(with_forces(J_torso[:, 3:6]), a_des_t - torso_drift, gains.w_torso)

    # --- Optional hand Cartesian tasks (hand point contacts), only with
    # refs.hand_pos ---
    if refs.hand_pos is not None and idx.hands:
        for s, fh in enumerate(idx.hands):
            Xh = rb.frame_pose(model, body_X, fh)
            Jh = rb.frame_jacobian(model, q, body_X, fh)[:, :3]
            drift_h = _frames_drift(model, q, v, (fh,), rows=slice(0, 3))
            a_des_h = gains.hand_kp * (refs.hand_pos[:, s] - Xh.p) - gains.hand_kd * _mv(Jh, v)
            add(with_forces(Jh), a_des_h - drift_h, gains.w_hand)

    # --- Postural task on the non-leg joints (wbid.py:128-134,167) ---
    qj, dqj = q[:, 7:], v[:, 6:]
    a_des_post = gains.posture_kp * (refs.posture_q - qj) - gains.posture_kd * dqj
    if idx.posture:
        add(idx.posture_A, a_des_post.index_select(1, idx.posture_index), gains.w_posture,
            level=2)

    # --- Optional leg postural task (the settle knee guard, WBIDGains.
    # w_posture_legs faded in by refs.posture_legs_scale) ---
    if refs.posture_legs_scale is not None and idx.legs:
        add(idx.legs_A, a_des_post.index_select(1, idx.legs_index),
            (gains.w_posture_legs * refs.posture_legs_scale)[:, None], level=2)

    # --- qddot regularization (wbid.py:152,167) ---
    add(idx.qddot_A, q.new_zeros((B, nv)), gains.w_qddot_reg, level=2)

    # --- Angular momentum task (wbid.py:136-142,168): Ldot_des = Ldot_ref +
    # K (L_ref - L) ---
    A_G = centroidal_momentum_matrix(model, q, body_X)
    L = _mv(A_G, v) if fast else _angular_momentum_impl(model, q, v, body_X, com)
    add(with_forces(A_G), refs.angmom_Ldot + gains.angmom_k * (refs.angmom_L - L) - L_drift,
        gains.w_angmom)

    # --- Torque minimization (wbid.py:149,170): tau = (M qdd + h - Jc' f)[6:] ---
    Jc_T = torch.cat([J.mT for J in Jc], dim=-1)  # (B, nv, 12)
    A_tau = torch.cat([M[:, 6:], -Jc_T[:, 6:]], dim=-1)
    add(A_tau, -h[:, 6:], gains.w_tau_reg, level=2)

    # --- Stance and swing tasks per foot (wbid.py:78-115,174-176) ---
    for s in range(2):
        Jf = J_feet[s]
        Xf = rb.frame_pose(model, body_X, idx.feet[s])
        vel = _mv(Jf, v)
        active = refs.contact_active[:, s, None]
        # Stance: hold the touchdown pose, zero velocity.
        e6 = torch.cat([refs.contact_pos[:, s] - Xf.p,
                        _rotation_error(refs.contact_R[:, s], Xf.R)], dim=-1)
        add(with_forces(Jf), gains.contact_kp * e6 - gains.contact_kd * vel - foot_drifts[s],
            gains.w_contact * active, level=0)
        # Swing: track the swing trajectory (6D gains; no angular feedforward).
        e6_sw = torch.cat([refs.swing_pos[:, s] - Xf.p,
                           _rotation_error(refs.swing_R[:, s], Xf.R)], dim=-1)
        zeros3 = q.new_zeros((B, 3))
        vel_ref6 = torch.cat([refs.swing_vel[:, s], zeros3], dim=-1)
        acc_ref6 = torch.cat([refs.swing_acc[:, s], zeros3], dim=-1)
        a_des6_sw = acc_ref6 + gains.swing_kp * e6_sw + gains.swing_kd * (vel_ref6 - vel)
        add(with_forces(Jf), a_des6_sw - foot_drifts[s], gains.w_swing * (1.0 - active),
            level=0)

    # --- Wrench tracking to the MPC forces (wbid.py:179-182,296-297): one
    # 12-row block on the fast path, one per contact otherwise ---
    if fast:
        add(idx.wrench_A, refs.f_des.reshape(B, NX_F), gains.w_wrench)
    else:
        for i in range(NF):
            add(idx.wrench_A[3 * i:3 * i + 3], refs.f_des[:, i], gains.w_wrench)

    # --- Net contact force tracking, per axis (the realized CoM dynamics
    # pinned to the plan; the distribution over contacts stays free) ---
    add(idx.total_force_A, torch.sum(refs.f_des, dim=1), gains.w_wrench_total)

    A_all = torch.cat(A_blocks, dim=1)
    b_all = torch.cat(b_blocks, dim=1)
    w_all = torch.cat(w_blocks, dim=1)
    AW = A_all * w_all[..., None]
    H = AW.mT @ A_all + 1e-8 * torch.eye(nx, dtype=dtype, device=device)
    g = -_mv(AW.mT, b_all)

    # ----- Constraints -----
    C_rows, l_rows, u_rows = [], [], []

    def addc(C, l, u):
        C_rows.append(C.expand(B, *C.shape[-2:]))
        l_rows.append(l)
        u_rows.append(u)

    # Dynamic feasibility, the underactuated base rows (wbid.py:184-190):
    # M[0:6] qdd - (Jc' f)[0:6] = -h[0:6].
    addc(torch.cat([M[:, 0:6], -Jc_T[:, 0:6]], dim=-1), -h[:, 0:6], -h[:, 0:6])

    # Joint limits at acceleration level (wbid.py:196-202): a
    # double-integrator viability bound over the lookahead T_lim; if the
    # window collapses, both bounds meet at the midpoint.
    T_lim = gains.qlim_lookahead
    qj_min = model.q_lower
    if refs.posture_legs_scale is not None:
        # The settle knee guard raises the knees' lower limit toward
        # gains.knee_floor as it fades in.
        scale = refs.posture_legs_scale[:, None]
        floor = scale * gains.knee_floor + (1.0 - scale) * qj_min
        qj_min = torch.where(idx.knee_mask, torch.maximum(qj_min, floor), qj_min)
    inv_T2 = 2.0 / (T_lim * T_lim)
    l_q = (qj_min - qj - T_lim * dqj) * inv_T2
    u_q = (model.q_upper - qj - T_lim * dqj) * inv_T2
    # Velocity limits over the same lookahead, with the reference's 10x
    # headroom (wbid.py:201-204).
    l_v = (-10.0 * model.dq_max - dqj) / T_lim
    u_v = (10.0 * model.dq_max - dqj) / T_lim
    lo = torch.maximum(l_q, l_v)
    hi = torch.minimum(u_q, u_v)
    mid = 0.5 * (lo + hi)
    bad = lo > hi
    addc(idx.joints_A, torch.where(bad, mid, lo), torch.where(bad, mid, hi))

    # Torque limits (wbid.py:206-211): |(M qdd + h - Jc' f)[6:]| <= tau_max.
    addc(A_tau, -model.tau_max - h[:, 6:], model.tau_max - h[:, 6:])

    # Friction cones and wrench boxes per contact (wbid.py:213-220,117-126):
    # per contact, 5 cone rows (a swing contact's rewritten into f = 0
    # equalities, as the reference's switch_procedure boxes it to zero,
    # ros_run_simulation.py:243) and 2 tangential box rows.
    # mu 0-d (shared) or (B,) (one per instance), as (1, 1) or (B, 1, 1).
    mu = gains.mu[..., None, None]
    if fast:
        act = refs.contact_active.index_select(1, idx.contact_foot)  # (B, NF)
        on = act > 0.5
        C_cone = torch.where(on[..., None, None], idx.cone_T0 - mu[..., None] * idx.cone_Tmu,
                             idx.cone_Teq)
        zeros5 = q.new_zeros((B, NF, 5))
        l_cone = torch.where(on[..., None], torch.cat(
            [q.new_full((B, NF, 4), -BIG), (gains.fz_min * act)[..., None]], dim=-1), zeros5)
        u_cone = torch.where(on[..., None], torch.cat(
            [q.new_zeros((B, NF, 4)), (gains.fz_max * act)[..., None]], dim=-1), zeros5)
        bxy = (gains.fxy_max * act)[..., None].expand(B, NF, 2)
        # Interleaved per contact, [cone 5, box 2] x NF: the loop's row order.
        addc(torch.cat([C_cone, idx.box_Txy.expand(B, NF, 2, nx)], dim=2).reshape(B, NF * 7, nx),
             torch.cat([l_cone, -bxy], dim=-1).reshape(B, NF * 7),
             torch.cat([u_cone, bxy], dim=-1).reshape(B, NF * 7))
    else:
        for i in range(NF):
            fa = refs.contact_active[:, CONTACT_FOOT[i], None]  # (B, 1)
            on = fa > 0.5
            zeros5 = q.new_zeros((B, 5))
            l_c = torch.cat([q.new_full((B, 4), -BIG), gains.fz_min * fa], dim=-1)
            u_c = torch.cat([q.new_zeros((B, 4)), gains.fz_max * fa], dim=-1)
            addc(torch.where(on[..., None], idx.cone_T0[i] - mu * idx.cone_Tmu[i],
                             idx.cone_Teq[i]),
                 torch.where(on, l_c, zeros5), torch.where(on, u_c, zeros5))
            bxy = (gains.fxy_max * fa).expand(B, 2)
            addc(idx.box_Txy[i], -bxy, bxy)

    C = torch.cat(C_rows, dim=1)
    l = torch.cat(l_rows, dim=1)
    u = torch.cat(u_rows, dim=1)
    if with_blocks:
        levels = np.asarray(sum(lvl_blocks, []), dtype=np.int32)
        return H, g, C, l, u, (M, h, Jc_T), (A_all, b_all, w_all, levels)
    return H, g, C, l, u, (M, h, Jc_T)
