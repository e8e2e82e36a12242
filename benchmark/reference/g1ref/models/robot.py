"""Robot model: the static kinematic tree as tensors, batched kinematics.

Port of ``g1_locomotion_tpu/models/robot.py``, batch-first: ``q (B, nq)``,
``v (B, nv)``; body placements come back as ``Transform(R (B, nb, 3, 3),
p (B, nb, 3))`` and Jacobians as ``(B, 6, nv)`` or ``(B, K, 6, nv)``. The
model itself has no batch axis.

Conventions (Pinocchio's, as in the reference):

* ``q = [base_pos(3), base_quat wxyz(4), qj(nj)]``;
* ``v = [v_base_local(3), w_base_local(3), dqj(nj)]``, the base twist in the
  base frame; accelerations use the same tangent layout.

The tree's index data (each joint's parent body, the ancestor mask, frame
rows) lives on the model's device as tensors, built once at load, so that
no call copies from the host.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.g1ref._device import require_cuda
from benchmark.reference.g1ref.core import rotations as rot
from benchmark.reference.g1ref.core.spatial import Transform
from benchmark.reference.g1ref.models.urdf import FrameSpec, RobotSpec, parse_urdf, spec_from_dict

ASSET_DIR = Path(__file__).parent / "assets"
VARIANTS = ("g1_23dof", "g1_29dof", "g1_29dof_with_hand", "g1_dual_arm")


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (M @ x[..., None])[..., 0]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Static robot description: float tensors, index tensors and the tree's
    static tuples.

    Body 0 is the floating base; bodies 1..nb-1 each carry one revolute
    joint. ``ancestor_mask[b][j] = 1`` iff joint j (body j+1's) lies on the
    path from the base to body b; ``ancestor`` is the same as a float tensor.
    """

    joint_origin_p: torch.Tensor  # (nb, 3) joint placement in the parent body frame
    joint_origin_R: torch.Tensor  # (nb, 3, 3)
    joint_axis: torch.Tensor      # (nb, 3) local joint axis
    mass: torch.Tensor            # (nb,)
    com: torch.Tensor             # (nb, 3) body-frame CoM offset
    inertia: torch.Tensor         # (nb, 3, 3) about the CoM, body frame
    q_lower: torch.Tensor         # (nj,)
    q_upper: torch.Tensor         # (nj,)
    dq_max: torch.Tensor          # (nj,)
    tau_max: torch.Tensor         # (nj,)
    frame_p: torch.Tensor         # (nf, 3) frame offset in its body's frame
    frame_R: torch.Tensor         # (nf, 3, 3)
    ancestor: torch.Tensor        # (nb, nj) float ancestor mask
    parent_index: torch.Tensor    # (nj,) long: the parent body of each joint's body

    parent: Tuple[int, ...]
    body_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]
    frame_names: Tuple[str, ...]
    frame_body: Tuple[int, ...]
    ancestor_mask: Tuple[Tuple[int, ...], ...]
    # Long index tensors on the model's device, one per tuple of indices asked
    # for (index()); filled on first use.
    _index_cache: Dict[Tuple[int, ...], torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def nb(self) -> int:
        return len(self.parent)

    @property
    def nj(self) -> int:
        return self.nb - 1

    @property
    def nv(self) -> int:
        return 6 + self.nj

    @property
    def nq(self) -> int:
        return 7 + self.nj

    @property
    def device(self) -> torch.device:
        return self.mass.device

    @property
    def dtype(self) -> torch.dtype:
        return self.mass.dtype

    @property
    def total_mass(self) -> torch.Tensor:
        return torch.sum(self.mass)

    def frame_index(self, name: str) -> int:
        return self.frame_names.index(name)

    def joint_index(self, name: str) -> int:
        return self.joint_names.index(name)

    def index(self, values: Sequence[int]) -> torch.Tensor:
        """A long tensor of `values` on the model's device, made once."""
        key = tuple(int(v) for v in values)
        if key not in self._index_cache:
            self._index_cache[key] = torch.tensor(key, dtype=torch.long, device=self.device)
        return self._index_cache[key]

    def to(self, device=None, dtype: Optional[torch.dtype] = None) -> "RobotModel":
        """The model on another device and / or float dtype."""
        changes = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if isinstance(value, torch.Tensor):
                changes[f.name] = value.to(
                    device=device, dtype=dtype if value.is_floating_point() else None)
        return dataclasses.replace(self, **changes, _index_cache={})


def model_from_spec(spec: RobotSpec, *, device, dtype=torch.float32) -> RobotModel:
    nb = len(spec.bodies)
    parent = tuple(b.parent for b in spec.bodies)

    joint_origin_p = np.zeros((nb, 3))
    joint_origin_R = np.tile(np.eye(3), (nb, 1, 1))
    joint_axis = np.zeros((nb, 3))
    mass = np.zeros(nb)
    com = np.zeros((nb, 3))
    inertia = np.zeros((nb, 3, 3))
    q_lower, q_upper, dq_max, tau_max = [], [], [], []
    joint_names = []
    for i, b in enumerate(spec.bodies):
        mass[i] = b.mass
        com[i] = b.com
        inertia[i] = b.inertia
        if b.joint is not None:
            joint_origin_p[i] = b.joint.origin_xyz
            joint_origin_R[i] = b.joint.origin_rot
            joint_axis[i] = b.joint.axis
            q_lower.append(b.joint.limit_lower)
            q_upper.append(b.joint.limit_upper)
            dq_max.append(b.joint.velocity)
            tau_max.append(b.joint.effort)
            joint_names.append(b.joint.name)
            if b.joint.jtype not in ("revolute", "continuous"):
                raise NotImplementedError(
                    f"joint {b.joint.name}: only revolute joints supported"
                )

    ancestor = np.zeros((nb, nb - 1), dtype=np.int64)
    for b in range(1, nb):
        k = b
        while k > 0:
            ancestor[b, k - 1] = 1
            k = parent[k]

    def t(x):
        return torch.tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)

    return RobotModel(
        joint_origin_p=t(joint_origin_p),
        joint_origin_R=t(joint_origin_R),
        joint_axis=t(joint_axis),
        mass=t(mass),
        com=t(com),
        inertia=t(inertia),
        q_lower=t(q_lower),
        q_upper=t(q_upper),
        dq_max=t(dq_max),
        tau_max=t(tau_max),
        frame_p=t(np.stack([f.xyz for f in spec.frames])),
        frame_R=t(np.stack([f.rot for f in spec.frames])),
        ancestor=t(ancestor),
        parent_index=torch.tensor(parent[1:], dtype=torch.long, device=device),
        parent=parent,
        body_names=tuple(b.name for b in spec.bodies),
        joint_names=tuple(joint_names),
        frame_names=tuple(f.name for f in spec.frames),
        frame_body=tuple(f.body for f in spec.frames),
        ancestor_mask=tuple(tuple(int(x) for x in row) for row in ancestor),
    )


def load_robot(variant: str = "g1_23dof", *, device=None, dtype=torch.float32) -> RobotModel:
    """Load a bundled robot variant (g1_23dof, g1_29dof, g1_29dof_with_hand,
    g1_dual_arm) onto `device` (the CUDA card when None).

    Variants whose description lacks the locomotion contact frames (the stock
    Unitree ``g1_29dof_with_hand``) get them synthesized at the documented
    offsets from the ankle-roll links (g1_23dof.urdf:283-301: heel x=-0.05,
    toe x=+0.12, center x=0, all z=-0.03)."""
    device = require_cuda() if device is None else device
    spec = spec_from_dict(json.loads((ASSET_DIR / f"{variant}.json").read_text()))
    _ensure_foot_contact_frames(spec)
    _ensure_hand_contact_frames(spec)
    return model_from_spec(spec, device=device, dtype=dtype)


def _ensure_foot_contact_frames(spec: RobotSpec) -> None:
    names = {f.name for f in spec.frames}
    offsets = {
        "line_contact_lower": [-0.05, 0.0, -0.03],
        "line_contact_upper": [0.12, 0.0, -0.03],
        "point_contact": [0.0, 0.0, -0.03],
    }
    for side in ("left", "right"):
        ankle = f"{side}_ankle_roll_link"
        body = next((i for i, b in enumerate(spec.bodies) if b.name == ankle), None)
        if body is None:
            continue
        for suffix, xyz in offsets.items():
            name = f"{side}_foot_{suffix}"
            if name not in names:
                spec.frames.append(FrameSpec(name, body, np.array(xyz), np.eye(3)))


def _ensure_hand_contact_frames(spec: RobotSpec) -> None:
    """Synthesize ``{side}_hand_point_contact`` frames for variants whose
    description lacks them (the reference defines them for the rubber-hand
    arms, g1_23dof.urdf:855-859: +0.17 m along the rubber-hand x axis; the
    dexterous-hand variant has none, so its contact point is synthesized at
    the palm frame). They carry the optional WBID hand tasks."""
    frames = {f.name: f for f in spec.frames}
    for side in ("left", "right"):
        name = f"{side}_hand_point_contact"
        if name in frames:
            continue
        base = None
        off = np.zeros(3)
        if f"{side}_rubber_hand" in frames:
            base = frames[f"{side}_rubber_hand"]
            off = np.array([0.17, 0.0, 0.0])
        elif f"{side}_hand_palm_link" in frames:
            base = frames[f"{side}_hand_palm_link"]
        if base is None:
            continue
        spec.frames.append(FrameSpec(name, base.body, base.xyz + base.rot @ off, base.rot.copy()))


def load_robot_from_urdf(urdf_string: str, *, device=None, dtype=torch.float32) -> RobotModel:
    device = require_cuda() if device is None else device
    return model_from_spec(parse_urdf(urdf_string), device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Forward kinematics
# ---------------------------------------------------------------------------


def _axis_angle_matrix(axis: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about a unit axis (..., 3) by theta (..., 1, 1)."""
    c, s = torch.cos(theta), torch.sin(theta)
    K = rot.skew(axis)
    return torch.eye(3, dtype=axis.dtype, device=axis.device) + s * K + (1.0 - c) * (K @ K)


def fk(model: RobotModel, q: torch.Tensor) -> Transform:
    """World placement of every body: R (B, nb, 3, 3), p (B, nb, 3).

    All joint rotations come from one batched Rodrigues pass; only the
    parent-chain composition (two small products per body) is sequential."""
    Rs = [rot.quat_to_matrix(q[:, 3:7])]
    ps = [q[:, 0:3]]
    R_pb_all = model.joint_origin_R[1:] @ _axis_angle_matrix(
        model.joint_axis[1:], q[:, 7:, None, None])  # (B, nj, 3, 3) joints in parents
    for b in range(1, model.nb):
        pa = model.parent[b]
        Rs.append(Rs[pa] @ R_pb_all[:, b - 1])
        ps.append(_mv(Rs[pa], model.joint_origin_p[b]) + ps[pa])
    return Transform(R=torch.stack(Rs, dim=1), p=torch.stack(ps, dim=1))


def frame_pose(model: RobotModel, body_X: Transform, frame_idx: int) -> Transform:
    """World placement of a named frame (static index; see model.frame_index):
    R (B, 3, 3), p (B, 3)."""
    b = model.frame_body[frame_idx]
    return Transform(R=body_X.R[:, b], p=body_X.p[:, b]).compose(
        Transform(R=model.frame_R[frame_idx], p=model.frame_p[frame_idx]))


def com_position(model: RobotModel, body_X: Transform) -> torch.Tensor:
    """Whole-body CoM in the world frame (B, 3) (replaces
    ModelInterface2.getCOM, ros_run_simulation.py:433)."""
    com_w = _mv(body_X.R, model.com) + body_X.p
    return torch.sum(model.mass[:, None] * com_w, dim=-2) / model.total_mass


def _joint_world_geometry(model: RobotModel, body_X: Transform):
    """World axis and origin (B, nj, 3) of each actuated joint."""
    Rp = body_X.R.index_select(1, model.parent_index)  # (B, nj, 3, 3)
    pp = body_X.p.index_select(1, model.parent_index)
    axis_w = _mv(Rp, _mv(model.joint_origin_R[1:], model.joint_axis[1:]))
    origin_w = _mv(Rp, model.joint_origin_p[1:]) + pp
    return axis_w, origin_w


def _base_columns(base_R: torch.Tensor, d: torch.Tensor):
    """The linear and angular Jacobian columns of the base's twist for points
    at offset d (..., 3) from the base origin: v = R v_loc + (R w_loc) x d,
    w = R w_loc. Returns (lin (..., 3, 6), ang (..., 3, 6))."""
    R = base_R.expand(*d.shape[:-1], 3, 3)
    lin = torch.cat([R, -rot.skew(d) @ R], dim=-1)
    ang = torch.cat([torch.zeros_like(R), R], dim=-1)
    return lin, ang


def point_jacobian(model: RobotModel, q: torch.Tensor, body_X: Transform,
                   frame_idx: int) -> torch.Tensor:
    """World-frame linear velocity Jacobian (B, 3, nv) of a frame's origin."""
    return frame_jacobian(model, q, body_X, frame_idx)[:, :3]


def frame_jacobian(model: RobotModel, q: torch.Tensor, body_X: Transform,
                   frame_idx: int) -> torch.Tensor:
    """World-frame 6D Jacobian (B, 6, nv) of a frame: rows [linear, angular],
    the "local world aligned" convention of the reference's Cartesian tasks
    (wbid.py:67-115)."""
    b = model.frame_body[frame_idx]
    p = frame_pose(model, body_X, frame_idx).p  # (B, 3)
    axis_w, origin_w = _joint_world_geometry(model, body_X)
    mask = model.ancestor[b][:, None]  # (nj, 1)
    lin_cols = mask * _cross(axis_w, p[:, None, :] - origin_w)  # (B, nj, 3)
    ang_cols = mask * axis_w
    lin_base, ang_base = _base_columns(body_X.R[:, 0], p - body_X.p[:, 0])
    J_lin = torch.cat([lin_base, lin_cols.mT], dim=-1)
    J_ang = torch.cat([ang_base, ang_cols.mT], dim=-1)
    return torch.cat([J_lin, J_ang], dim=-2)


def frame_jacobians(model: RobotModel, q: torch.Tensor, body_X: Transform,
                    frame_idxs: Sequence[int]) -> torch.Tensor:
    """World-frame 6D Jacobians (B, K, 6, nv) of K static frames in one pass:
    the same values as :func:`frame_jacobian` per frame, with the frame poses
    and mask products batched over the frames (the serving path's assembly,
    ``WBIDConfig.fast_stack``, counts operations, not FLOPs)."""
    bodies = model.index([model.frame_body[f] for f in frame_idxs])
    frames = model.index(frame_idxs)
    Rb = body_X.R.index_select(1, bodies)  # (B, K, 3, 3)
    pb = body_X.p.index_select(1, bodies)
    p = _mv(Rb, model.frame_p.index_select(0, frames)) + pb  # (B, K, 3) frame origins

    axis_w, origin_w = _joint_world_geometry(model, body_X)  # (B, nj, 3)
    mask = model.ancestor.index_select(0, bodies)[..., None]  # (K, nj, 1)
    diff = p[:, :, None, :] - origin_w[:, None, :, :]  # (B, K, nj, 3)
    lin_cols = mask * _cross(axis_w[:, None].expand_as(diff), diff)
    ang_cols = mask * axis_w[:, None]
    lin_base, ang_base = _base_columns(body_X.R[:, None, 0], p - body_X.p[:, None, 0])
    J_lin = torch.cat([lin_base, lin_cols.mT], dim=-1)
    J_ang = torch.cat([ang_base, ang_cols.mT], dim=-1)
    return torch.cat([J_lin, J_ang], dim=-2)


def com_jacobian(model: RobotModel, q: torch.Tensor, body_X: Transform) -> torch.Tensor:
    """World-frame CoM linear Jacobian (B, 3, nv) (replaces getCOMJacobian,
    reference run_simulation.py:71)."""
    com_b_w = _mv(body_X.R, model.com) + body_X.p  # (B, nb, 3)
    total_com = torch.sum(model.mass[:, None] * com_b_w, dim=-2) / model.total_mass

    axis_w, origin_w = _joint_world_geometry(model, body_X)
    # Column j = sum_b m_b / M * mask[b, j] * a_j x (com_b - o_j).
    diff = com_b_w[:, :, None, :] - origin_w[:, None, :, :]  # (B, nb, nj, 3)
    contrib = _cross(axis_w[:, None].expand_as(diff), diff)
    w = (model.mass[:, None] * model.ancestor) / model.total_mass  # (nb, nj)
    Jj = torch.einsum("bj,Bbjk->Bkj", w, contrib)  # (B, 3, nj)
    lin_base, _ = _base_columns(body_X.R[:, 0], total_com - body_X.p[:, 0])
    return torch.cat([lin_base, Jj], dim=-1)


def com_velocity(model: RobotModel, q: torch.Tensor, v: torch.Tensor,
                 body_X: Transform) -> torch.Tensor:
    """World-frame CoM linear velocity (B, 3) (replaces getCOMVelocity,
    ros_run_simulation.py:438)."""
    return _mv(com_jacobian(model, q, body_X), v)


def integrate_q(model: RobotModel, q: torch.Tensor, v: torch.Tensor, dt) -> torch.Tensor:
    """Integrate the configuration with tangent v (base twist local): a
    Lie-group step on the free flyer, Euler on the joints."""
    base_R = rot.quat_to_matrix(q[:, 3:7])
    dp_world = _mv(base_R, v[:, 0:3]) * dt
    w_world = _mv(base_R, v[:, 3:6])
    new_quat = rot.quat_integrate(q[:, 3:7], w_world, dt)
    return torch.cat([q[:, 0:3] + dp_world, new_quat, q[:, 7:] + v[:, 6:] * dt], dim=-1)
