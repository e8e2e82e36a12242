"""Single-Rigid-Body-Dynamics (SRBD) model: linearization, discretization,
horizon condensation.

Port of ``g1_locomotion_tpu/models/srbd.py``. Every function takes leading
batch dimensions ``(...)`` in front of the reference's per-instance shapes
(the reference vmaps; here the batch is written out).

State (13): ``x = [theta(3) rpy, p(3) CoM, omega(3) world ang vel,
v(3) CoM vel, g]`` with gravity appended to keep the dynamics linear.

Continuous dynamics, linearized about the reference yaw psi:
    theta_dot = Rz(psi)^T omega
    p_dot     = v
    omega_dot = I_w^{-1} sum_i (r_i x f_i),  r_i = c_i - p,  I_w = Rz I_b Rz^T
    v_dot     = sum_i f_i / m + e_z * g      (x[12] = -9.80665)

A_c is nilpotent (A_c^3 = 0), so the ZOH ``A_d = I + A_c dt + A_c^2 dt^2/2``
is exact and B_d uses the matching series through third order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from benchmark.reference.g1ref.core.rotations import skew, yaw_matrix
from benchmark.reference.g1ref.models import robot as rb
from benchmark.reference.g1ref.models.robot import RobotModel

NX = 13  # state dim
NU = 12  # 4 contacts x 3 forces
NC = 4   # contact points: L-heel, L-toe, R-heel, R-toe

# Torso-only inertia of the original controller's MPC. Kept for parity runs;
# NOT the default: it over-predicts body rotation from lateral forces ~30x.
TORSO_INERTIA = (
    (8.20564e-2, 0.0, 0.0),
    (0.0, 8.05015e-2, 0.0),
    (0.0, 0.0, 0.32353e-2),
)
# Whole-body composite inertia about the CoM at the standing configuration
# (from the g1_23dof URDF link inertias).
G1_COMPOSITE_INERTIA = (
    (3.2056, 0.0, 0.4255),
    (0.0, 3.0501, -0.0007),
    (0.4255, -0.0007, 0.5523),
)
G1_MASS = 34.13290  # sum of URDF link masses (g1_23dof.urdf)
GRAVITY = -9.80665  # state element 12


class SRBDParams(NamedTuple):
    """SRBD parameters: ``mass`` 0-d (shared by a batch) or (B,) and
    ``inertia`` (3, 3) or (B, 3, 3), one per instance; ``m_swing`` shared."""

    mass: torch.Tensor     # 0-d or (B,)
    inertia: torch.Tensor  # (3, 3) or (B, 3, 3) body-frame rotational inertia
    # Effective swing-limb point mass [kg] for the angular-momentum preview
    # (0 = off); see the reference's SRBDParams.m_swing.
    m_swing: Union[torch.Tensor, float] = 0.0


def default_params(*, device, dtype=torch.float32) -> SRBDParams:
    return SRBDParams(
        mass=torch.tensor(G1_MASS, dtype=dtype, device=device),
        inertia=torch.tensor(G1_COMPOSITE_INERTIA, dtype=dtype, device=device),
        m_swing=torch.tensor(0.0, dtype=dtype, device=device),
    )


def reference_parity_params(*, device, dtype=torch.float32) -> SRBDParams:
    """The original controller's SRBD parameterization (torso inertia)."""
    return SRBDParams(
        mass=torch.tensor(G1_MASS, dtype=dtype, device=device),
        inertia=torch.tensor(TORSO_INERTIA, dtype=dtype, device=device),
    )


def params_from_model(model: RobotModel, q: torch.Tensor) -> SRBDParams:
    """SRBD parameters of a whole-body model at one configuration q ((nq,)
    or (1, nq)): the total mass and the composite inertia about the
    whole-body CoM, both shared by a batch. Each robot variant needs its own:
    the 23-DoF constants destabilize the other variants' walking gaits."""
    q = q.reshape(1, -1)
    X = rb.fk(model, q)
    R, p = X.R[0], X.p[0]  # (nb, 3, 3), (nb, 3)
    com_b = torch.einsum("bij,bj->bi", R, model.com) + p
    com = torch.sum(model.mass[:, None] * com_b, dim=0) / model.total_mass
    I_w = torch.einsum("bij,bjk,blk->bil", R, model.inertia, R)
    d = com_b - com[None, :]
    d2 = torch.sum(d * d, dim=1)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    shift = model.mass[:, None, None] * (
        d2[:, None, None] * eye[None] - d[:, :, None] * d[:, None, :])
    inertia = torch.sum(I_w + shift, dim=0)
    return SRBDParams(mass=model.total_mass.to(q.dtype), inertia=inertia.to(q.dtype),
                      m_swing=torch.zeros((), dtype=q.dtype, device=q.device))


def _per_instance(x: torch.Tensor, batch_ndim: int, shared_ndim: int) -> torch.Tensor:
    """A parameter shared by the batch (``shared_ndim`` dims) as it is, or one
    per instance ((B, ...)) with its batch axis aligned to the leading axis
    of ``batch_ndim`` batch dims: (B, 1, ..., 1, ...)."""
    if x.dim() == shared_ndim:
        return x
    return x.reshape(x.shape[:1] + (1,) * (batch_ndim - 1) + x.shape[1:])


def _world_inertia(params: SRBDParams, yaw: torch.Tensor, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Rz, I_w = Rz I_b Rz^T), batched over yaw's shape (the batch axis
    first)."""
    Rz = yaw_matrix(yaw).to(dtype)
    I_w = Rz @ _per_instance(params.inertia, yaw.dim(), 2).to(dtype) @ Rz.mT
    return Rz, I_w


def continuous_matrices(
    params: SRBDParams,
    yaw: torch.Tensor,  # (...)
    r: torch.Tensor,    # (..., NC, 3) contact positions relative to the CoM (world)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A_c (..., NX, NX), B_c (..., NX, NU)) of the yaw-linearized SRBD."""
    dtype, device = r.dtype, r.device
    batch = r.shape[:-2]
    Rz, I_w = _world_inertia(params, yaw, dtype)
    I_w_inv = torch.linalg.inv_ex(I_w).inverse
    eye3 = torch.eye(3, dtype=dtype, device=device)

    A = torch.zeros(batch + (NX, NX), dtype=dtype, device=device)
    A[..., 0:3, 6:9] = Rz.mT
    A[..., 3:6, 9:12] = eye3
    A[..., 11, 12] = 1.0

    B = torch.zeros(batch + (NX, NU), dtype=dtype, device=device)
    B[..., 6:9, :] = torch.cat(
        [I_w_inv @ skew(r[..., i, :]) for i in range(NC)], dim=-1
    )
    inv_m = 1.0 / _per_instance(params.mass, len(batch), 0)
    B[..., 9:12, :] = torch.cat([eye3 * inv_m[..., None, None]] * NC, dim=-1)
    return A, B


def landing_sensitivity(
    params: SRBDParams,
    yaw: torch.Tensor,        # (...)
    f_nom_sum: torch.Tensor,  # (..., 3) summed nominal force on the landing contacts
) -> torch.Tensor:
    """Continuous-dynamics columns E (..., NX, 2) for a shared landing offset
    d = [dx, dy]: ``omega_dot += I_w^{-1} (d x f_nom_sum)``, linear in d."""
    dtype = f_nom_sum.dtype
    _, I_w = _world_inertia(params, yaw, dtype)
    I_w_inv = torch.linalg.inv_ex(I_w).inverse
    fx, fy, fz = f_nom_sum[..., 0], f_nom_sum[..., 1], f_nom_sum[..., 2]
    zero = torch.zeros_like(fz)
    M = torch.stack(
        [torch.stack([zero, fz], -1), torch.stack([-fz, zero], -1),
         torch.stack([fy, -fx], -1)],
        dim=-2,
    )  # (..., 3, 2)
    E = torch.zeros(f_nom_sum.shape[:-1] + (NX, 2), dtype=dtype, device=f_nom_sum.device)
    E[..., 6:9, :] = I_w_inv @ M
    return E


def _zoh(A: torch.Tensor, dt: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A_d, G) with A_d = exp(A dt) and G = int_0^dt exp(A s) ds, exact for
    A^3 = 0: A_d = I + A dt + A^2 dt^2/2, G = I dt + A dt^2/2 + A^2 dt^3/6."""
    eye = torch.eye(NX, dtype=A.dtype, device=A.device)
    A2 = A @ A
    Ad = eye + A * dt + A2 * (dt * dt / 2.0)
    G = eye * dt + A * (dt * dt / 2.0) + A2 * (dt**3 / 6.0)
    return Ad, G


def discretize(
    A: torch.Tensor, B: torch.Tensor, dt: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact ZOH for the nilpotent SRBD A (A^3 = 0). Batched."""
    Ad, G = _zoh(A, dt)
    return Ad, G @ B


def swing_disturbance(
    params: SRBDParams,
    yaw: torch.Tensor,        # (...)
    hdot_geom: torch.Tensor,  # (..., 3) geometric r_sw x a_sw of the swing foot
) -> torch.Tensor:
    """Continuous affine disturbance (..., NX) of the swing-limb momentum
    preview: ``omega_dot -= I_w^{-1} m_swing (r_foot x a_foot)``."""
    dtype = hdot_geom.dtype
    _, I_w = _world_inertia(params, yaw, dtype)
    w = torch.zeros(hdot_geom.shape[:-1] + (NX,), dtype=dtype, device=hdot_geom.device)
    w[..., 6:9] = -torch.linalg.solve_ex(I_w, params.m_swing * hdot_geom).result
    return w


def discretize_affine(A: torch.Tensor, w: torch.Tensor, dt: float) -> torch.Tensor:
    """ZOH of a constant affine term over one step (same series as B_d)."""
    return (_zoh(A, dt)[1] @ w[..., None])[..., 0]


def lift_affine(Ad: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Condensed affine horizon term W (..., N*NX), ``X = A_qp x0 + B_qp U + W``
    with ``W[k] = sum_{j<=k} Phi_{j+1..k} w_j``."""
    N = Ad.shape[-3]
    acc = wd[..., 0, :]
    rows = [acc]
    for k in range(1, N):
        acc = (Ad[..., k, :, :] @ acc[..., None])[..., 0] + wd[..., k, :]
        rows.append(acc)
    return torch.cat(rows, dim=-1)


def condense(
    Ad: torch.Tensor,  # (..., N, NX, NX) per-step discrete A
    Bd: torch.Tensor,  # (..., N, NX, NU) per-step discrete B
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lift the horizon into ``X = A_qp x0 + B_qp U``.

    X stacks x_1..x_N (N*NX); U stacks u_0..u_{N-1} (N*NU).
    A_qp[k] = prod_{j<=k} A_j ;  B_qp[k, j] = (prod_{j<i<=k} A_i) B_j.
    Returns A_qp (..., N*NX, NX) and B_qp (..., N*NX, N*NU).
    """
    N = Ad.shape[-3]
    batch = Ad.shape[:-3]

    Phi = [Ad[..., 0, :, :]]
    for k in range(1, N):
        Phi.append(Ad[..., k, :, :] @ Phi[-1])
    A_qp = torch.cat(Phi, dim=-2)

    # Row recurrence: row_k = A_k @ row_{k-1} + e_k (x) B_k.
    rows = []
    row = torch.zeros(batch + (NX, N * NU), dtype=Ad.dtype, device=Ad.device)
    for k in range(N):
        if k > 0:
            row = Ad[..., k, :, :] @ row  # a fresh tensor: earlier rows stay intact
        row[..., :, k * NU : (k + 1) * NU] = Bd[..., k, :, :]
        rows.append(row)
    B_qp = torch.cat(rows, dim=-2)
    return A_qp, B_qp


def rollout(
    Ad: torch.Tensor, Bd: torch.Tensor, x0: torch.Tensor, U: torch.Tensor,
    Ed: Optional[torch.Tensor] = None, d: Optional[torch.Tensor] = None,
    wd: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Simulate x_{k+1} = A_k x_k + B_k u_k (+ E_k d + w_k); returns (..., N+1, NX)."""
    N = Ad.shape[-3]
    xs = [x0]
    for k in range(N):
        x = (Ad[..., k, :, :] @ xs[-1][..., None] + Bd[..., k, :, :] @ U[..., k, :, None])[..., 0]
        if Ed is not None:
            x = x + (Ed[..., k, :, :] @ d[..., None])[..., 0]
        if wd is not None:
            x = x + wd[..., k, :]
        xs.append(x)
    return torch.stack(xs, dim=-2)
