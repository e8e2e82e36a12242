"""SRBD MPC: condensed dense QP over contact forces, solved by the batched ADMM.

Port of ``g1_locomotion_tpu/mpc/solver.py``, batch-first: every input and
output carries a leading batch dimension B (inputs shared by the whole batch
may omit it and are broadcast). The chain per solve is SRBD linearization ->
ZOH -> condensation -> friction-cone rows -> segmented ADMM with active-set
polish -> rollout.

Contact masking is static-shape: inactive contacts keep their QP columns
but are boxed to f = 0 by rewritten constraint rows.

With ``MPCConfig.footstep_opt`` the upcoming landing's xy offset d is a QP
decision too (two more variables, scaled by ``d_scale``, and two reach-box
rows); ``hdot_sw`` adds the swing-limb momentum preview as an affine term of
the prediction. ``MPCConfig.roll_moment_max > 0`` caps the roll moment of
the contact forces about the CoM at every knot (one more row a knot; off by
default: it was measured negative in the reference).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from benchmark.reference.g1ref._device import const
from benchmark.reference.g1ref.models import srbd
from benchmark.reference.g1ref.models.srbd import NC, NU, NX
from benchmark.reference.g1ref.ops import qp as qplib

class MPCConfig(NamedTuple):
    """Static MPC configuration (shapes depend on horizon); the reference's
    fields and defaults."""

    horizon: int = 10          # N
    dt: float = 0.04           # MPC discretization [s]
    move_block: int = 1        # force knots constant over blocks of this
                               # many steps (1 = per-step forces)
    mu: float = 0.8            # friction coefficient
    fz_min: float = 10.0       # min normal force in stance [N]
    fz_max: float = 1000.0     # max normal force [N]
    footstep_opt: bool = False  # landing offset d as a QP decision
    roll_moment_max: float = 0.0  # hard roll-moment cap [N m] if > 0
    w_d: float = 300.0         # footstep_opt: penalty on the landing offset
    d_scale: float = 1e-3      # footstep_opt: QP units of the offset
    d_box: float = 0.05        # footstep_opt: reach box [m]
    qp: qplib.QPConfig = qplib.QPConfig(iters=60, scaling_iters=0, rho=1.0,
                                        rho_segments=2, polish_rounds=2,
                                        iter_precision="high")


class MPCWeights(NamedTuple):
    """Diagonal cost weights."""

    Q: torch.Tensor  # (NX,) state weights
    R: torch.Tensor  # (NU,) force regularization


_DEFAULT_Q = (
    5.0, 5.0, 50.0,        # theta rpy
    200.0, 200.0, 500.0,   # p com
    0.1, 0.1, 0.5,         # omega
    10.0, 10.0, 10.0,      # v com
    0.0,                   # g (uncontrollable)
)


def default_weights(*, device, dtype=torch.float32) -> MPCWeights:
    return MPCWeights(
        Q=torch.tensor(_DEFAULT_Q, dtype=dtype, device=device),
        R=torch.full((NU,), 1e-5, dtype=dtype, device=device),
    )


def walking_weights(*, device, dtype=torch.float32) -> MPCWeights:
    """Weights for dynamic walking: planar velocity weighted 10x, the roll
    channel priced honestly (theta_x 30, omega_x 3)."""
    w = default_weights(device=device, dtype=dtype)
    Q = w.Q.clone()
    Q[9], Q[10], Q[0], Q[6] = 100.0, 100.0, 30.0, 3.0
    return w._replace(Q=Q)


class MPCSolution(NamedTuple):
    u0: torch.Tensor         # (B, NU) first-step GRFs
    U: torch.Tensor          # (B, N, NU) full force plan (warm-start state)
    x_horizon: torch.Tensor  # (B, N+1, NX) predicted states, row 0 = x0
    d: torch.Tensor          # (B, 2) optimized landing offset (0 unless footstep_opt)
    pri_res: torch.Tensor    # (B,)
    dua_res: torch.Tensor    # (B,)


def _constraint_blocks(cfg: MPCConfig, dtype, device):
    """Per-contact constraint rows (5 rows per contact per knot), each (5, 3).

    Active contact: friction pyramid |fx|, |fy| <= mu fz and
    fz_min <= fz <= fz_max. Inactive contact: the same 5 rows rewritten into
    clean equalities fx = fy = fz = 0 plus two trivial 0 <= 0 <= 0 rows (the
    degenerate pyramid at fz = 0 stalls ADMM and breaks the polish).
    """
    mu = cfg.mu
    like = torch.empty((), dtype=dtype, device=device)
    C_active = const(((1.0, 0.0, -mu), (-1.0, 0.0, -mu), (0.0, 1.0, -mu), (0.0, -1.0, -mu),
                      (0.0, 0.0, 1.0)), like)
    C_inactive = const(((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0), (0.0, 0.0, 0.0),
                        (0.0, 0.0, 0.0)), like)
    return C_active, C_inactive


def build_qp(
    cfg: MPCConfig,
    weights: MPCWeights,
    params: srbd.SRBDParams,
    x0: torch.Tensor,               # (B, NX)
    x_ref: torch.Tensor,            # ([B,] N, NX) references for x_1..x_N
    contact_horizon: torch.Tensor,  # ([B,] N, NC) 0/1 flags
    c_horizon: torch.Tensor,        # ([B,] N, NC, 3) world contact positions
    p_com_horizon: torch.Tensor,    # ([B,] N, 3) CoM positions for lever arms
    landing_mask: Optional[torch.Tensor] = None,  # ([B,] N, NC) 1 where a contact
                                    # sits at the upcoming landing (footstep_opt)
    f_nom: Optional[torch.Tensor] = None,  # ([B,] N, NC, 3) nominal forces of the
                                    # d x f linearization (footstep_opt)
    hdot_sw: Optional[torch.Tensor] = None,  # ([B,] N, 3) geometric swing-limb
                                    # r x a horizon, scaled by params.m_swing
):
    """Assemble the batched condensed QP and the lifting matrices:
    (H, g, A, l, u, A_qp, B_qp, Ad, Bd, Ed, Wd); Ed (B, N, NX, 2) is None
    unless footstep_opt, Wd (B, N, NX) None without hdot_sw."""
    N = cfg.horizon
    B = x0.shape[0]
    dtype, device = x0.dtype, x0.device
    x_ref = x_ref.expand(B, N, NX)
    contact_horizon = contact_horizon.expand(B, N, NC)
    c_horizon = c_horizon.expand(B, N, NC, 3)
    p_com_horizon = p_com_horizon.expand(B, N, 3)

    # Per-step linearization about the reference yaw.
    yaw_hor = x_ref[..., 2]                                # (B, N)
    r_hor = c_horizon - p_com_horizon[:, :, None, :]       # (B, N, NC, 3)
    A_c, B_c = srbd.continuous_matrices(params, yaw_hor, r_hor)
    Ad, Bd = srbd.discretize(A_c, B_c, cfg.dt)             # (B, N, NX, NX/NU)

    if hdot_sw is None:
        Wd = None
    else:
        w_c = srbd.swing_disturbance(params, yaw_hor, hdot_sw.expand(B, N, 3))
        Wd = srbd.discretize_affine(A_c, w_c, cfg.dt)  # (B, N, NX)

    A_qp, B_qp = srbd.condense(Ad, Bd)  # (B, N*NX, NX), (B, N*NX, N*NU)

    Ed = E_qp = None
    if cfg.footstep_opt:
        if landing_mask is None:
            landing_mask = x0.new_zeros((N, NC))
        if f_nom is None:
            f_nom = x0.new_zeros((N, NC, 3))
        f_sum = torch.einsum("bnc,bncd->bnd", landing_mask.expand(B, N, NC),
                             f_nom.expand(B, N, NC, 3))  # (B, N, 3)
        E_c = srbd.landing_sensitivity(params, yaw_hor, f_sum)
        _, Ed = srbd.discretize(A_c, E_c, cfg.dt)  # (B, N, NX, 2)
        # Condense the shared d columns: row_k = A_k row_{k-1} + E_k; the QP
        # variable is d_hat = d / d_scale.
        rows = []
        row = Ed[:, 0]
        rows.append(row)
        for k in range(1, N):
            row = Ad[:, k] @ row + Ed[:, k]
            rows.append(row)
        E_qp = torch.cat(rows, dim=-2) * cfg.d_scale  # (B, N*NX, 2)

    Qbar = weights.Q.repeat(N)  # (N*NX,)

    # Move blocking: per-step forces folded into K knots by the selector S.
    mb = max(1, cfg.move_block)
    K_knots = (N + mb - 1) // mb
    if mb > 1:
        step_to_knot = torch.tensor([min(k // mb, K_knots - 1) for k in range(N)], device=device)
        S_sel = (step_to_knot[:, None] == torch.arange(K_knots, device=device)[None, :]).to(dtype)
        S = torch.kron(S_sel, torch.eye(NU, dtype=dtype, device=device))  # (N*NU, K*NU)
        B_qp = B_qp @ S
        Rbar = weights.R.repeat(K_knots) * mb
        # A knot is inactive if ANY step of its block is inactive.
        pad = torch.ones((B, K_knots * mb - N, NC), dtype=dtype, device=device)
        ch = torch.cat([contact_horizon.to(dtype), pad], dim=1)
        contact_knots = torch.amin(ch.reshape(B, K_knots, mb, NC), dim=2)
    else:
        Rbar = weights.R.repeat(N)
        contact_knots = contact_horizon

    # Footstep decision columns after the (possibly knot-folded) forces.
    if E_qp is not None:
        B_qp = torch.cat([B_qp, E_qp], dim=-1)
        Rbar = torch.cat([Rbar, Rbar.new_full((2,), cfg.w_d * cfg.d_scale**2)])

    # H = B'QB + R ; g = B'Q (A x0 + W - X_ref), W the lifted swing-momentum
    # preview (none without hdot_sw)
    BtQ = B_qp.mT * Qbar
    H = BtQ @ B_qp + torch.diag(Rbar)
    resid = (A_qp @ x0[..., None])[..., 0]
    if Wd is not None:
        resid = resid + srbd.lift_affine(Ad, Wd)
    resid = resid - x_ref.reshape(B, N * NX)
    g = (BtQ @ resid[..., None])[..., 0]

    # Friction cones, block-diagonal over (K_knots, NC).
    C_act, C_inact = _constraint_blocks(cfg, dtype, device)
    NK = K_knots * NC
    act = contact_knots.reshape(B, NK) > 0.5                       # (B, NK)
    blocks = torch.where(act[:, :, None, None], C_act, C_inact)    # (B, NK, 5, 3)
    eye = torch.eye(NK, dtype=dtype, device=device)
    A_con = (eye[None, :, None, :, None] * blocks[:, :, :, None, :]).reshape(B, NK * 5, NK * 3)

    fz_min = torch.full((B, NK), cfg.fz_min, dtype=dtype, device=device)
    fz_max = torch.full((B, NK), cfg.fz_max, dtype=dtype, device=device)
    zeros = torch.zeros((B, NK), dtype=dtype, device=device)
    neg_inf = torch.full((B, NK), -1e20, dtype=dtype, device=device)
    l_act = torch.stack([neg_inf] * 4 + [fz_min], dim=-1)
    u_act = torch.stack([zeros] * 4 + [fz_max], dim=-1)
    l = torch.where(act[..., None], l_act, 0.0).reshape(B, NK * 5)
    u = torch.where(act[..., None], u_act, 0.0).reshape(B, NK * 5)

    if E_qp is not None:
        # Two zero columns for d in the cone rows, and the reach box
        # |dx|, |dy| <= d_box.
        n_var = NK * 3 + 2
        box = torch.cat([A_con.new_zeros((2, NK * 3)),
                         torch.eye(2, dtype=dtype, device=device)], dim=-1)
        A_con = torch.cat([torch.cat([A_con, A_con.new_zeros((B, NK * 5, 2))], dim=-1),
                           box.expand(B, 2, n_var)], dim=-2)
        reach = cfg.d_box / cfg.d_scale
        l = torch.cat([l, l.new_full((B, 2), -reach)], dim=-1)
        u = torch.cat([u, u.new_full((B, 2), reach)], dim=-1)

    if cfg.roll_moment_max > 0.0:
        # Roll-moment cap |sum_i (r_ik x f_ik)_x| <= roll_moment_max per knot:
        # (r x f)_x = r_y f_z - r_z f_y, so knot k's row has (0, -r_z, r_y)
        # on each contact's forces, r from the knot's first step (k mb < N).
        r_knot = r_hor[:, 0:N:mb]                                     # (B, K, NC, 3)
        lever = torch.stack([torch.zeros_like(r_knot[..., 2]), -r_knot[..., 2],
                             r_knot[..., 1]], dim=-1)
        eye_k = torch.eye(K_knots, dtype=dtype, device=device)
        M_rows = (eye_k[None, :, :, None, None] * lever[:, :, None]).reshape(
            B, K_knots, K_knots * NU)
        if E_qp is not None:
            # d_y moves the landing contacts' lever: d(M_x)/d(d_y) is the
            # landing's summed fz of the linearization forces (scaled as d).
            fz_land = torch.einsum("bnc,bnc->bn", landing_mask.expand(B, N, NC),
                                   f_nom.expand(B, N, NC, 3)[..., 2])
            dcol = torch.stack([torch.zeros_like(fz_land[:, 0:N:mb]),
                                fz_land[:, 0:N:mb] * cfg.d_scale], dim=-1)
            M_rows = torch.cat([M_rows, dcol], dim=-1)
        A_con = torch.cat([A_con, M_rows], dim=-2)
        l = torch.cat([l, l.new_full((B, K_knots), -cfg.roll_moment_max)], dim=-1)
        u = torch.cat([u, u.new_full((B, K_knots), cfg.roll_moment_max)], dim=-1)

    return H, g, A_con, l, u, A_qp, B_qp, Ad, Bd, Ed, Wd


def solve(
    cfg: MPCConfig,
    weights: MPCWeights,
    params: srbd.SRBDParams,
    x0: torch.Tensor,
    x_ref: torch.Tensor,
    contact_horizon: torch.Tensor,
    c_horizon: torch.Tensor,
    p_com_horizon: torch.Tensor,
    U_warm: Optional[torch.Tensor] = None,
    landing_mask: Optional[torch.Tensor] = None,
    f_nom: Optional[torch.Tensor] = None,
    hdot_sw: Optional[torch.Tensor] = None,
) -> MPCSolution:
    """One batched MPC update: ``(B, ...)`` states and horizons in, first-step
    forces ``u0`` (B, NU) and the predicted state horizon out; with
    ``footstep_opt`` also the landing offset d (B, 2), linearized about
    ``f_nom`` (by default the warm start U_warm)."""
    N = cfg.horizon
    B = x0.shape[0]
    mb = max(1, cfg.move_block)
    K_knots = (N + mb - 1) // mb
    if cfg.footstep_opt and f_nom is None and U_warm is not None:
        f_nom = U_warm.reshape(B, N, NC, 3)
    H, g, A_con, l, u, A_qp, B_qp, Ad, Bd, Ed, Wd = build_qp(
        cfg, weights, params, x0, x_ref, contact_horizon, c_horizon,
        p_com_horizon, landing_mask=landing_mask, f_nom=f_nom, hdot_sw=hdot_sw,
    )
    if U_warm is None:
        x0_warm = None
    else:
        # Each knot's first step (k * mb < N for every knot k): a view, no
        # index tensor copied from the host.
        x0_warm = U_warm[:, 0:N:mb].reshape(B, K_knots * NU)
        if cfg.footstep_opt:
            x0_warm = torch.cat([x0_warm, x0_warm.new_zeros((B, 2))], dim=-1)
    sol = qplib.solve_qp(H, g, A_con, l, u, cfg=cfg.qp, x0=x0_warm)
    if cfg.footstep_opt:
        xU, d = sol.x[:, :-2], sol.x[:, -2:] * cfg.d_scale
    else:
        xU, d = sol.x, x0.new_zeros((B, 2))
    U = xU.reshape(B, K_knots, NU).repeat_interleave(mb, dim=1)[:, :N]
    # Hard-zero swing-contact forces: the QP boxes them to [0, 0], so any
    # residual is ADMM slack; masking makes the invariant exact downstream.
    U = U * contact_horizon.expand(B, N, NC).to(U.dtype).repeat_interleave(3, dim=-1)
    x_hor = srbd.rollout(Ad, Bd, x0, U, Ed=Ed, d=d, wd=Wd)
    return MPCSolution(
        u0=U[:, 0], U=U, x_horizon=x_hor, d=d,
        pri_res=sol.pri_res, dua_res=sol.dua_res,
    )


class MPCSolver(nn.Module):
    """The MPC update as a module: holds the SRBD parameters and the cost
    weights as buffers (so ``.to(device)`` moves them) and calls
    :func:`solve` with a fixed :class:`MPCConfig`."""

    def __init__(self, cfg: MPCConfig, weights: MPCWeights, params: srbd.SRBDParams):
        super().__init__()
        self.cfg = cfg
        like = dict(dtype=weights.Q.dtype, device=weights.Q.device)
        self.register_buffer("Q", weights.Q)
        self.register_buffer("R", weights.R.to(**like))
        self.register_buffer("mass", torch.as_tensor(params.mass, **like))
        self.register_buffer("inertia", torch.as_tensor(params.inertia, **like))
        self.register_buffer("m_swing", torch.as_tensor(params.m_swing, **like))

    @property
    def weights(self) -> MPCWeights:
        return MPCWeights(Q=self.Q, R=self.R)

    @property
    def params(self) -> srbd.SRBDParams:
        return srbd.SRBDParams(mass=self.mass, inertia=self.inertia, m_swing=self.m_swing)

    def forward(self, x0, x_ref, contact_horizon, c_horizon, p_com_horizon,
                U_warm=None, landing_mask=None, hdot_sw=None) -> MPCSolution:
        return solve(self.cfg, self.weights, self.params, x0, x_ref,
                     contact_horizon, c_horizon, p_com_horizon, U_warm=U_warm,
                     landing_mask=landing_mask, hdot_sw=hdot_sw)
