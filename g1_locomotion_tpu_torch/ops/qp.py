"""Batched dense QP solver (OSQP-style ADMM), batch-first.

Port of ``g1_locomotion_tpu/ops/qp.py``. Problem form (OSQP):

    min  0.5 x' P x + q' x    s.t.  l <= A x <= u

Every array carries a leading batch dimension: P (B, n, n), q (B, n),
A (B, m, n), l and u (B, m); the solution is batched the same way. The
reference writes a single-instance solver and vmaps it; here the batch is
explicit, so each kernel launch covers the whole batch and B = 1 serving
and large-B throughput run the same kernels.

Design (as in the reference):
* fixed iteration count, split into ``rho_segments`` segments with an
  OSQP spectral rho update and a refactor between them;
* per-row rho: equality rows (l == u) get a stiffer penalty; rho tracks the
  Ruiz cost factor ``c``;
* optional Ruiz equilibration (fixed sweeps);
* optional active-set polish: masked equality-KKT solves, kept per
  instance only where they improve the KKT residual.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from g1_locomotion_tpu_torch._device import capturable_lu
from g1_locomotion_tpu_torch.ops import cuda_lin
from g1_locomotion_tpu_torch.ops.lin import spd_inverse


class QPSolution(NamedTuple):
    x: torch.Tensor        # (B, n) primal
    z: torch.Tensor        # (B, m) projected constraint values
    y: torch.Tensor        # (B, m) dual
    pri_res: torch.Tensor  # (B,) ||Ax - z||_inf
    dua_res: torch.Tensor  # (B,) ||Px + q + A'y||_inf


class QPConfig(NamedTuple):
    iters: int = 60
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6
    alpha: float = 1.6
    scaling_iters: int = 5  # Ruiz sweeps (0 = off)
    polish: bool = True
    polish_reg: float = 1e-9
    rho_segments: int = 4  # spectral rho updates + refactor between segments
    matmul_inverse: bool = True  # recursive matmul SPD inverse (ops/lin.py)
    # instead of Cholesky + triangular solves and an LU polish
    polish_rounds: int = 3  # active-set re-detection rounds
    polish_refine: int = 0  # iterative-refinement passes on the LU polish
    # solve (matmul_inverse=False only): x += K^-1 (rhs - K x)
    polish_kernel: bool = False  # serving path (matmul_inverse only): the
    # ADMM K^-1 and the polish Hr^-1 run on kernel B2 (gj_inverse), each ADMM
    # segment on kernel B4 (admm_iterate), the polish Schur solve on kernel
    # B3 (gj_solve)
    iter_precision: str = "highest"  # kept so the reference's configs load;
    # NO EFFECT here. In the reference it names a TPU MXU pass count ("high"
    # = 3 bf16 passes); it must not become
    # torch.set_float32_matmul_precision("high"), which turns on TF32. Every
    # product in this package runs in IEEE fp32 (or fp64).


BIG = 1e20  # sentinel for +-infinity bounds


def _inf_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(v), dim=-1)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, r, c) x (B, c) -> (B, r)."""
    return (M @ v[..., None])[..., 0]


def _mtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M' v: (B, r, c) x (B, r) -> (B, c)."""
    return (v[..., None, :] @ M)[..., 0, :]


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _ruiz_equilibrate(P, q, A, l, u, iters: int):
    """Modified Ruiz equilibration on the stacked KKT matrix [[P, A'], [A, 0]].

    Returns the scaled (P, q, A, l, u) and the diagonal scalings (d, e, c);
    the solution unscales as x = d x^, y = e y^ / c.
    """
    B, n, m = P.shape[0], P.shape[-1], A.shape[-2]
    d = P.new_ones((B, n))
    e = P.new_ones((B, m))
    c = P.new_ones((B,))
    # Track unbounded rows so scaling can't overflow the +-BIG sentinels.
    l_unb = l < -0.5 * BIG
    u_unb = u > 0.5 * BIG
    MIN_S, MAX_S = 1e-4, 1e4
    for _ in range(iters):
        Pn = torch.amax(torch.abs(P), dim=-2)   # column norms (B, n)
        An = torch.amax(torch.abs(A), dim=-2)   # (B, n)
        ATn = torch.amax(torch.abs(A), dim=-1)  # (B, m)
        # All-zero rows/columns stay unscaled (else e/d diverge across sweeps).
        col_norm = torch.maximum(Pn, An)
        delta_d = torch.where(
            col_norm > 1e-12,
            torch.clamp(1.0 / torch.sqrt(torch.clamp(col_norm, min=1e-12)), MIN_S, MAX_S),
            1.0,
        )
        delta_e = torch.where(
            ATn > 1e-12,
            torch.clamp(1.0 / torch.sqrt(torch.clamp(ATn, min=1e-12)), MIN_S, MAX_S),
            1.0,
        )
        P = P * delta_d[:, :, None] * delta_d[:, None, :]
        q = q * delta_d
        A = A * delta_e[:, :, None] * delta_d[:, None, :]
        d = d * delta_d
        e = e * delta_e
        gamma = torch.clamp(
            1.0 / torch.clamp(
                torch.maximum(torch.mean(torch.amax(torch.abs(P), dim=-2), dim=-1),
                              _inf_norm(q)),
                min=1e-12,
            ),
            MIN_S, MAX_S,
        )
        P = P * gamma[:, None, None]
        q = q * gamma[:, None]
        c = c * gamma
    l = torch.where(l_unb, -BIG, e * torch.where(l_unb, 0.0, l))
    u = torch.where(u_unb, BIG, e * torch.where(u_unb, 0.0, u))
    return P, q, A, l, u, d, e, c


def _build_K(P, A, rho_vec, sigma):
    """K = P + sigma I + A' diag(rho) A, batched."""
    return P + sigma * _eye(P.shape[-1], P) + (A.mT * rho_vec[:, None, :]) @ A


def _make_solver(K, matmul_inverse: bool):
    """A solve(rhs) closure for the batched K: the precomputed matmul
    inverse, or a Cholesky factorization (reference path)."""
    if matmul_inverse:
        Kinv = spd_inverse(K)
        return lambda b: _mv(Kinv, b)
    L = torch.linalg.cholesky_ex(K).L  # no host sync; a failed factor shows as NaN

    def solve(b):
        w = torch.linalg.solve_triangular(L, b[..., None], upper=False)
        return torch.linalg.solve_triangular(L.mT, w, upper=True)[..., 0]

    return solve


def solve_qp(
    P: torch.Tensor,
    q: torch.Tensor,
    A: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    cfg: QPConfig = QPConfig(),
    x0: Optional[torch.Tensor] = None,
    y0: Optional[torch.Tensor] = None,
) -> QPSolution:
    """Solve a batch of dense QPs, ``(B, ...)`` in and out. x0/y0 (optional)
    warm starts are (B, n) / (B, m)."""
    B, n, m = P.shape[0], P.shape[-1], A.shape[-2]

    if cfg.scaling_iters > 0:
        P_s, q_s, A_s, l_s, u_s, d, e, c = _ruiz_equilibrate(P, q, A, l, u, cfg.scaling_iters)
    else:
        P_s, q_s, A_s, l_s, u_s = P, q, A, l, u
        d = P.new_ones((B, n))
        e = P.new_ones((B, m))
        c = P.new_ones((B,))

    is_eq = torch.abs(u_s - l_s) < 1e-12
    # rho tracks the cost scaling c: an unscaled rho is off by 1/c relative
    # to the curvature and stalls ADMM.
    rho_vec = c[:, None] * torch.where(
        is_eq, cfg.rho * cfg.rho_eq_scale, torch.full_like(u_s, cfg.rho)
    )

    # Scaled variables: x^ = x/d, y^ = c y/e.
    x = P.new_zeros((B, n)) if x0 is None else x0 / d
    z = _mv(A_s, x)
    y = P.new_zeros((B, m)) if y0 is None else y0 * c[:, None] / e

    def iterate(x, z, y, solve, rho_vec, num):
        for _ in range(num):
            rhs = cfg.sigma * x - q_s + _mtv(A_s, rho_vec * z - y)
            x_t = solve(rhs)
            z_t = _mv(A_s, x_t)
            x_n = cfg.alpha * x_t + (1 - cfg.alpha) * x
            z_ax = cfg.alpha * z_t + (1 - cfg.alpha) * z
            z_n = torch.clamp(z_ax + y / rho_vec, min=l_s, max=u_s)
            y = y + rho_vec * (z_ax - z_n)
            x, z = x_n, z_n
        return x, z, y

    if cfg.polish_kernel and cfg.matmul_inverse:
        # B4 reads its operands as contiguous (B, ...) buffers.
        A_k, q_k, l_k, u_k = (t.contiguous() for t in (A_s, q_s, l_s, u_s))

    segs = max(1, cfg.rho_segments)
    per = max(1, cfg.iters // segs)
    for s in range(segs):
        num = per if s < segs - 1 else cfg.iters - per * (segs - 1)
        if cfg.polish_kernel and cfg.matmul_inverse:
            # Serving path: the segment's K^-1 on B2, its `num` iterations on B4.
            Kinv = cuda_lin.gj_inverse(_build_K(P_s, A_s, rho_vec, cfg.sigma).contiguous())
            x, z, y = cuda_lin.admm_iterate(
                Kinv, A_k, q_k, l_k, u_k, rho_vec.contiguous(),
                x.contiguous(), z.contiguous(), y.contiguous(),
                num, cfg.sigma, cfg.alpha,
            )
        else:
            solve = _make_solver(_build_K(P_s, A_s, rho_vec, cfg.sigma), cfg.matmul_inverse)
            x, z, y = iterate(x, z, y, solve, rho_vec, num)
        if s < segs - 1:
            Ax = _mv(A_s, x)
            Px = _mv(P_s, x)
            ATy = _mtv(A_s, y)
            pri = _inf_norm(Ax - z) / torch.clamp(
                torch.maximum(_inf_norm(Ax), _inf_norm(z)), min=1e-6
            )
            dua = _inf_norm(Px + q_s + ATy) / torch.clamp(
                torch.maximum(_inf_norm(Px), torch.maximum(_inf_norm(q_s), _inf_norm(ATy))),
                min=1e-6,
            )
            scale = torch.clamp(torch.sqrt(pri / torch.clamp(dua, min=1e-12)), 1e-2, 1e2)
            # Cumulative clamp: a runaway rho makes K numerically singular in f32.
            rho_vec = torch.clamp(rho_vec * scale[:, None], 1e-4, 1e6)

    if cfg.polish:
        x, y = _polish(P_s, q_s, A_s, l_s, u_s, x, y, cfg, rounds=cfg.polish_rounds)
        z = torch.clamp(_mv(A_s, x), min=l_s, max=u_s)

    # Unscale.
    x_out = d * x
    y_out = e * y / c[:, None]
    z_out = z / e

    pri_res = _inf_norm(_mv(A, x_out) - z_out)
    dua_res = _inf_norm(_mv(P, x_out) + q + _mtv(A, y_out))
    return QPSolution(x=x_out, z=z_out, y=y_out, pri_res=pri_res, dua_res=dua_res)


def _polish(P, q, A, l, u, x, y, cfg: QPConfig, rounds: int = 3):
    """Iterative active-set polish, batched.

    Each round guesses the active set from dual signs and primal slacks,
    solves the equality-KKT system with inactive rows masked to identity
    (their dual forced to 0), and keeps the result per instance only where
    the KKT residual improved.
    """
    n, m = P.shape[-1], A.shape[-2]
    eye_n = _eye(n, P)
    eye_m = _eye(m, P)
    reg = cfg.polish_reg
    # Hr is constant across rounds: its inverse once (matmul path).
    if cfg.matmul_inverse and cfg.polish_kernel:
        Hr_inv = cuda_lin.gj_inverse((P + reg * eye_n).contiguous())
    elif cfg.matmul_inverse:
        Hr_inv = spd_inverse(P + reg * eye_n)
    else:
        Hr_inv = None

    def kkt(xx, yy):
        Axx = _mv(A, xx)
        zz = torch.clamp(Axx, min=l, max=u)
        comp_low = torch.clamp(yy, max=0.0) * (Axx - l)
        comp_up = torch.clamp(yy, min=0.0) * (Axx - u)
        return torch.maximum(
            torch.maximum(_inf_norm(Axx - zz), _inf_norm(_mv(P, xx) + q + _mtv(A, yy))),
            torch.maximum(_inf_norm(comp_low), _inf_norm(comp_up)),
        )

    best = kkt(x, y)
    span = torch.clamp(torch.abs(u - l), min=1.0)
    is_eq = torch.abs(u - l) < 1e-12
    for _ in range(rounds):
        Ax = _mv(A, x)
        slack_tol = 10.0 * torch.clamp(best, min=1e-12)[:, None]
        tol = torch.minimum(slack_tol, 1e-4 * span)
        low_active = (y < -1e-10) | (Ax - l < tol)
        upp_active = (y > 1e-10) | (u - Ax < tol)
        # A row can't be active on both sides unless it's an equality.
        upp_active = torch.where(is_eq, upp_active, upp_active & ~low_active)
        active = low_active | upp_active
        b_act = torch.where(low_active, l, torch.where(upp_active, u, torch.zeros_like(u)))

        mask = active.to(P.dtype)
        A_m = A * mask[:, :, None]
        b_t = b_act * mask
        if cfg.matmul_inverse:
            # KKT solve through the SPD Schur complement:
            #   [Hr  Am'][x]   [-q]      Hr = P + reg I
            #   [Am  -Dm][y] = [ b]      Dm = diag(1 - mask) + reg I
            #   y = (Am Hr^-1 Am' + Dm)^-1 (Am Hr^-1 (-q) - b); x = Hr^-1 (-q - Am' y)
            AmHi = A_m @ Hr_inv
            S = AmHi @ A_m.mT + torch.diag_embed(1.0 - mask) + reg * eye_m
            rhs_y = _mv(AmHi, -q) - b_t
            if cfg.polish_kernel:
                y_p = cuda_lin.gj_solve(S.contiguous(), rhs_y.contiguous())
            else:
                y_p = _mv(spd_inverse(S), rhs_y)
            x_p = _mv(Hr_inv, -q - _mtv(A_m, y_p))
        else:
            # Exact indefinite-KKT LU solve (+ optional iterative refinement
            # reusing the factors).
            top = torch.cat([P + reg * eye_n, A_m.mT], dim=-1)
            bot = torch.cat([A_m, -torch.diag_embed(1.0 - mask) - reg * eye_m], dim=-1)
            Kkt = torch.cat([top, bot], dim=-2)
            rhs = torch.cat([-q, b_t], dim=-1)
            with capturable_lu(Kkt):
                if cfg.polish_refine == 0:
                    sol = torch.linalg.solve_ex(Kkt, rhs).result
                else:
                    LU, piv, _ = torch.linalg.lu_factor_ex(Kkt)
                    sol = torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]
                    for _ in range(cfg.polish_refine):
                        r = rhs - _mv(Kkt, sol)
                        sol = sol + torch.linalg.lu_solve(LU, piv, r[..., None])[..., 0]
            x_p, y_p = sol[:, :n], sol[:, n:]
        res_p = kkt(x_p, y_p)
        better = (res_p < best)[:, None]
        x = torch.where(better, x_p, x)
        y = torch.where(better, y_p, y)
        best = torch.minimum(best, res_p)
    return x, y


def kkt_residuals(P, q, A, l, u, x, y):
    """Primal/dual feasibility and complementarity residuals, each (B,)."""
    Ax = _mv(A, x)
    pri = torch.maximum(torch.amax(Ax - u, dim=-1), torch.amax(l - Ax, dim=-1))
    pri = torch.clamp(pri, min=0.0)
    dua = _inf_norm(_mv(P, x) + q + _mtv(A, y))
    comp_low = torch.clamp(y, max=0.0) * (Ax - l)
    comp_up = torch.clamp(y, min=0.0) * (Ax - u)
    comp = torch.maximum(_inf_norm(comp_low), _inf_norm(comp_up))
    return pri, dua, comp
