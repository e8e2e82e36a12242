"""Swing-foot trajectory: sextic z profile and sine-eased xy, closed form in
the swing's progress.

Port of ``g1_locomotion_tpu/gait/swing.py``, batched over any leading
dimensions: ``p_start`` and ``p_end`` are ``(..., 3)``, ``z_apex`` and the
progress ``s`` broadcast against their leading dimensions (the engine
evaluates ``(B,)`` swings, the planner ``(B, N)`` horizon knots of one swing
per instance).

* z(s): 6th-order polynomial through (start, apex at s = 1/2, end) with zero
  boundary velocity and acceleration, except a -0.02 m/s terminal
  z-velocity for a firm touchdown.
* x, y(s): sine-eased phase covering 80% of the distance in the first half
  of the swing, linear after.

The 7 x 7 boundary-condition system has a constant matrix; its inverse is
computed once here, so the coefficients are one (7 x 7) product.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from benchmark.reference.g1ref._device import const

# Boundary conditions of z(s) = sum c_k s^k, s in [0, 1]:
# rows z(0), z'(0), z''(0), z(1/2), z(1), z'(1), z''(1).
_A = np.array(
    [
        [1, 0, 0, 0, 0, 0, 0],
        [0, 1, 0, 0, 0, 0, 0],
        [0, 0, 2, 0, 0, 0, 0],
        [1, 0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625],
        [1, 1, 1, 1, 1, 1, 1],
        [0, 1, 2, 3, 4, 5, 6],
        [0, 0, 2, 6, 12, 20, 30],
    ]
)
_A_INV = tuple(map(tuple, np.linalg.inv(_A).tolist()))

TOUCHDOWN_ZVEL = -0.02  # m/s
XY_FIRST_HALF_FRACTION = 0.80


class SwingParams(NamedTuple):
    """One swing's boundary data per instance."""

    p_start: torch.Tensor  # (..., 3) lift-off position (world)
    p_end: torch.Tensor    # (..., 3) landing position (world)
    z_apex: Union[torch.Tensor, float]  # apex height above z = 0


def z_coefficients(params: SwingParams) -> torch.Tensor:
    """(..., 7) coefficients of z(s)."""
    p0, p1 = params.p_start, params.p_end
    if isinstance(params.z_apex, torch.Tensor):
        z0, z1, z_apex = torch.broadcast_tensors(p0[..., 2], p1[..., 2], params.z_apex)
    else:
        z0, z1 = torch.broadcast_tensors(p0[..., 2], p1[..., 2])
        z_apex = torch.full_like(z0, params.z_apex)
    zero = torch.zeros_like(z0)
    b = torch.stack([z0, zero, zero, z_apex, z1, zero + TOUCHDOWN_ZVEL, zero], dim=-1)
    return (const(_A_INV, p0) @ b[..., None])[..., 0]


def xy_phase(s: torch.Tensor) -> torch.Tensor:
    """Sine-eased progress: 80% of the distance in the first half, linear after."""
    first = XY_FIRST_HALF_FRACTION * torch.sin(math.pi * s)
    second = XY_FIRST_HALF_FRACTION + (s - 0.5) * (1 - XY_FIRST_HALF_FRACTION) * 2.0
    return torch.where(s <= 0.5, first, second)


def xy_phase_rate(s: torch.Tensor) -> torch.Tensor:
    """d(phase)/ds."""
    first = XY_FIRST_HALF_FRACTION * math.pi * torch.cos(math.pi * s)
    second = torch.full_like(s, (1 - XY_FIRST_HALF_FRACTION) * 2.0)
    return torch.where(s <= 0.5, first, second)


def xy_phase_accel(s: torch.Tensor) -> torch.Tensor:
    """d2(phase)/ds2 (zero in the linear second half): the xy acceleration
    profile that drives the planner's swing-momentum preview."""
    first = -XY_FIRST_HALF_FRACTION * math.pi**2 * torch.sin(math.pi * s)
    return torch.where(s <= 0.5, first, torch.zeros_like(s))


def evaluate(
    params: SwingParams, s: torch.Tensor, swing_duration
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(position, velocity, acceleration), each (..., 3), of the swing foot at
    progress s in [0, 1]; velocity and acceleration in world units (divided
    by the swing duration)."""
    s = torch.clamp(s, 0.0, 1.0)
    coeff = z_coefficients(params)
    zeros = torch.zeros_like(s)
    powers = torch.stack([s**k for k in range(7)], dim=-1)
    dpowers = torch.stack([zeros] + [k * s ** (k - 1) for k in range(1, 7)], dim=-1)
    ddpowers = torch.stack([zeros, zeros] + [k * (k - 1) * s ** (k - 2) for k in range(2, 7)],
                           dim=-1)
    z = torch.sum(coeff * powers, dim=-1)
    dz = torch.sum(coeff * dpowers, dim=-1) / swing_duration
    ddz = torch.sum(coeff * ddpowers, dim=-1) / swing_duration**2

    ph = xy_phase(s)[..., None]
    dph = (xy_phase_rate(s) / swing_duration)[..., None]
    ddph = (xy_phase_accel(s) / swing_duration**2)[..., None]
    p0, p1 = params.p_start[..., :2], params.p_end[..., :2]
    xy = (1 - ph) * p0 + ph * p1
    dxy = dph * (p1 - p0)
    ddxy = ddph * (p1 - p0)
    return (torch.cat([xy, z[..., None]], dim=-1), torch.cat([dxy, dz[..., None]], dim=-1),
            torch.cat([ddxy, ddz[..., None]], dim=-1))
