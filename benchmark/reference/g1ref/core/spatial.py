"""Spatial (6D) rigid-body algebra, Featherstone style, batched.

Port of ``g1_locomotion_tpu/core/spatial.py``. Same conventions:

* Motion vectors are ``[v_lin(3), w_ang(3)]``, linear first (Pinocchio's
  order); force vectors ``[lin(3), ang(3)]``.
* A frame placement is ``(R, p)``: the rotation of the frame's axes in the
  parent, and its origin in parent coordinates.

Every function is plain tensor code, batched over leading dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.g1ref.core.rotations import skew


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., i, j) x (..., j) -> (..., i)."""
    return (M @ x[..., None])[..., 0]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


class Transform(NamedTuple):
    """Frame placement: x_parent = R @ x_local + p."""

    R: torch.Tensor  # (..., 3, 3)
    p: torch.Tensor  # (..., 3)

    def compose(self, other: "Transform") -> "Transform":
        """self o other: placement of other's frame through self."""
        return Transform(R=self.R @ other.R, p=_mv(self.R, other.p) + self.p)

    def inverse(self) -> "Transform":
        RT = self.R.mT
        return Transform(R=RT, p=-_mv(RT, self.p))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Transform a point from local to parent coordinates."""
        return _mv(self.R, x) + self.p

    def rotate(self, v: torch.Tensor) -> torch.Tensor:
        """Rotate a (free) vector from local to parent coordinates."""
        return _mv(self.R, v)


def transform_identity(*, device, dtype=torch.float64) -> Transform:
    return Transform(R=torch.eye(3, dtype=dtype, device=device),
                     p=torch.zeros(3, dtype=dtype, device=device))


def motion_transform(X: Transform, m: torch.Tensor) -> torch.Tensor:
    """Express motion vector m = [v, w] (in frame B) in frame A, X = placement
    of B in A: v_A = R v_B + p x (R w_B), w_A = R w_B."""
    v, w = m[..., :3], m[..., 3:]
    Rw = X.rotate(w)
    return torch.cat([X.rotate(v) + _cross(X.p, Rw), Rw], dim=-1)


def motion_transform_inv(X: Transform, m: torch.Tensor) -> torch.Tensor:
    """Express a motion vector from frame A in frame B (X = placement of B in A)."""
    v, w = m[..., :3], m[..., 3:]
    RT = X.R.mT
    return torch.cat([_mv(RT, v - _cross(X.p, w)), _mv(RT, w)], dim=-1)


def force_transform(X: Transform, f: torch.Tensor) -> torch.Tensor:
    """Express force vector f = [lin, ang] (in frame B) in frame A (X = B placed
    in A): n_A = R n_B + p x (R f_B), f_A = R f_B."""
    lin, ang = f[..., :3], f[..., 3:]
    Rl = X.rotate(lin)
    return torch.cat([Rl, X.rotate(ang) + _cross(X.p, Rl)], dim=-1)


def force_transform_inv(X: Transform, f: torch.Tensor) -> torch.Tensor:
    """Express a force vector from frame A in frame B (X = placement of B in A)."""
    lin, ang = f[..., :3], f[..., 3:]
    RT = X.R.mT
    return torch.cat([_mv(RT, lin), _mv(RT, ang - _cross(X.p, lin))], dim=-1)


def motion_cross(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product m x x for motion vector x = [v, w]:
    [w_m x v_x + v_m x w_x, w_m x w_x]."""
    vm, wm = m[..., :3], m[..., 3:]
    vx, wx = x[..., :3], x[..., 3:]
    return torch.cat([_cross(wm, vx) + _cross(vm, wx), _cross(wm, wx)], dim=-1)


def motion_cross_force(m: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product m x* f for force vector f = [lin, ang]:
    [w_m x lin, w_m x ang + v_m x lin]."""
    vm, wm = m[..., :3], m[..., 3:]
    lf, af = f[..., :3], f[..., 3:]
    return torch.cat([_cross(wm, lf), _cross(wm, af) + _cross(vm, lf)], dim=-1)


class SpatialInertia(NamedTuple):
    """Rigid-body spatial inertia about the body frame's origin, as
    (m, h = m c, I_o) with I_o the rotational inertia about the origin."""

    m: torch.Tensor  # (...,)
    h: torch.Tensor  # (..., 3) first mass moment m * com
    I: torch.Tensor  # (..., 3, 3) inertia about the origin

    def apply(self, motion: torch.Tensor) -> torch.Tensor:
        """f = I_spatial @ [v, w]: lin = m v - h x w, ang = I_o w + h x v."""
        v, w = motion[..., :3], motion[..., 3:]
        lin = self.m[..., None] * v - _cross(self.h, w)
        ang = _mv(self.I, w) + _cross(self.h, v)
        return torch.cat([lin, ang], dim=-1)

    def to_matrix(self) -> torch.Tensor:
        """Dense 6x6 (linear first): [[m 1, -S(h)], [S(h), I_o]]."""
        eye = torch.eye(3, dtype=self.I.dtype, device=self.I.device)
        mI = self.m[..., None, None] * eye
        Sh = skew(self.h)
        top = torch.cat([mI, -Sh], dim=-1)
        bot = torch.cat([Sh, self.I], dim=-1)
        return torch.cat([top, bot], dim=-2)


def spatial_inertia_from_params(m: torch.Tensor, com: torch.Tensor,
                                I_com: torch.Tensor) -> SpatialInertia:
    """Spatial inertia from mass, CoM offset and inertia about the CoM."""
    h = m[..., None] * com
    # Parallel axis: I_o = I_c + m (c.c 1 - c c').
    c2 = torch.sum(com * com, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=I_com.dtype, device=I_com.device)
    I_o = I_com + m[..., None, None] * (c2 * eye - com[..., :, None] * com[..., None, :])
    return SpatialInertia(m=m, h=h, I=I_o)


def inertia_transform(X: Transform, si: SpatialInertia) -> SpatialInertia:
    """Express a spatial inertia given in frame B in frame A (X = placement of
    B in A)."""
    m = si.m
    com_B = si.h / torch.where(m[..., None] == 0, torch.ones_like(m[..., None]), m[..., None])
    eye = torch.eye(3, dtype=si.I.dtype, device=si.I.device)
    I_com = si.I - m[..., None, None] * (
        torch.sum(com_B * com_B, dim=-1)[..., None, None] * eye
        - com_B[..., :, None] * com_B[..., None, :]
    )
    return spatial_inertia_from_params(m, X.apply(com_B), X.R @ I_com @ X.R.mT)


def inertia_add(a: SpatialInertia, b: SpatialInertia) -> SpatialInertia:
    return SpatialInertia(m=a.m + b.m, h=a.h + b.h, I=a.I + b.I)
