"""SO(3) utilities: quaternions, rotation matrices, Euler angles, skew maps.

Port of ``g1_locomotion_tpu/core/rotations.py``. Same conventions:

* Quaternions are **scalar-first** ``(w, x, y, z)``; ``wxyz_from_xyzw`` /
  ``xyzw_from_wxyz`` convert from and to the scalar-last layout.
* Euler angles are roll-pitch-yaw ``(r, p, y)`` with
  ``R = Rz(y) @ Ry(p) @ Rx(r)`` (``tf.transformations`` 'sxyz').

All functions are plain tensor code, batched over leading dimensions.
"""

from __future__ import annotations

import torch


def _mat3(rows) -> torch.Tensor:
    """Stack nine (...,) tensors given as 3 rows of 3 into (..., 3, 3)."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix S(v) with S(v) @ u = v x u. Batched."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return _mat3([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(w,x,y,z) quaternion -> 3x3 rotation matrix. Batched."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return _mat3(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> (w,x,y,z) quaternion. Batched, branch-free.

    Builds all four candidate quaternions and keeps the one with the largest
    dominance score (the numerically stable choice); sign canonical w >= 0.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    s = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    idx = torch.argmax(s, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    gather_idx = idx[..., None, None].expand(*idx.shape, 1, 4)
    q = torch.gather(cands, -2, gather_idx)[..., 0, :]
    q = quat_normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (w,x,y,z). Batched."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (world = R(q) @ v). Batched."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis + angle -> (w,x,y,z)."""
    half = angle / 2.0
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]], dim=-1)


def rpy_to_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """Roll-pitch-yaw -> rotation matrix, R = Rz(y) Ry(p) Rx(r)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return _mat3(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def matrix_to_rpy(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> roll-pitch-yaw (inverse of rpy_to_matrix).
    Gimbal-safe via a clipped asin."""
    sp = torch.clamp(-R[..., 2, 0], -1.0, 1.0)
    p = torch.arcsin(sp)
    r = torch.arctan2(R[..., 2, 1], R[..., 2, 2])
    y = torch.arctan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([r, p, y], dim=-1)


def quat_to_rpy(q: torch.Tensor) -> torch.Tensor:
    return matrix_to_rpy(quat_to_matrix(q))


def rpy_to_quat(rpy: torch.Tensor) -> torch.Tensor:
    return matrix_to_quat(rpy_to_matrix(rpy))


def yaw_matrix(yaw: torch.Tensor) -> torch.Tensor:
    """Rz(yaw) — the SRBD linearization rotates body rates by yaw only."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    return _mat3([[c, -s, zero], [s, c, zero], [zero, zero, one]])


def wxyz_from_xyzw(q: torch.Tensor) -> torch.Tensor:
    """Scalar-last (x,y,z,w) -> internal scalar-first (w,x,y,z)."""
    return torch.cat([q[..., 3:4], q[..., 0:3]], dim=-1)


def xyzw_from_wxyz(q: torch.Tensor) -> torch.Tensor:
    """Internal (w,x,y,z) -> scalar-last (x,y,z,w)."""
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate orientation quaternion with world-frame angular velocity over dt."""
    angle = torch.linalg.norm(omega_world, dim=-1)
    # Safe normalize: any axis will do for ~zero rotation (sin(0) = 0).
    safe = torch.where(angle[..., None] > 1e-12, omega_world, torch.ones_like(omega_world))
    axis = safe / torch.linalg.norm(safe, dim=-1, keepdim=True)
    dq = quat_from_axis_angle(axis, angle * dt)
    return quat_normalize(quat_mul(dq, q))
