"""The four dense linear-algebra kernels of the QP, as plain PyTorch.

Under the wrapper names that ``ops/lin.py`` and ``ops/qp.py`` call, on any
device, launching no kernel of the program. The three factorizations are
PyTorch's own, without their error checks (a factorization that fails
gives NaN or garbage, which the comparison fails, rather than an
exception): B1's base case is ``torch.linalg.cholesky_ex`` and a triangular
solve, B2 ``torch.linalg.inv_ex``, B3 ``torch.linalg.solve_ex``.
The ADMM segment (B4) is the plain loop of the port's ``admm_iterate_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., r, c) x (..., c) -> (..., r)."""
    return (M @ v[..., None])[..., 0]


def chol_inverse_base(K: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W = L^-1 with K = L L' for (..., n, n), returned, or copied into
    ``out`` (which may be a view) where that is given."""
    L, _ = torch.linalg.cholesky_ex(K)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device).expand(K.shape)
    W = torch.linalg.solve_triangular(L, eye, upper=False)
    return W if out is None else out.copy_(W)


def gj_inverse(K: torch.Tensor) -> torch.Tensor:
    """K^-1 for SPD + ridge K (..., m, m)."""
    return torch.linalg.inv_ex(K).inverse


def gj_solve(K: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = K^-1 b for SPD + ridge K (..., m, m), b (..., m)."""
    return torch.linalg.solve_ex(K, b[..., None]).result[..., 0]


def admm_iterate_ref(Kinv, A, q, l, u, rho_vec, x, z, y, num: int, sigma: float,
                     alpha: float):
    """Plain version of B4: ``num`` relaxed-ADMM iterations of the batched QP
    (Kinv (..., n, n), A (..., m, n), vectors (..., n) / (..., m)), the update
    of ops/qp.py's iteration loop with x~ = K^-1 rhs. Returns (x, z, y)."""
    for _ in range(num):
        rhs = sigma * x - q + _mv(A.mT, rho_vec * z - y)
        x_t = _mv(Kinv, rhs)
        z_t = _mv(A, x_t)
        x_n = alpha * x_t + (1 - alpha) * x
        z_ax = alpha * z_t + (1 - alpha) * z
        z_n = torch.clamp(z_ax + y / rho_vec, min=l, max=u)
        y = y + rho_vec * (z_ax - z_n)
        x, z = x_n, z_n
    return x, z, y


admm_iterate = admm_iterate_ref
