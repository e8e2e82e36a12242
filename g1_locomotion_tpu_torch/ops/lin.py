"""Matmul-only batched SPD inverse: recursive blocked Cholesky.

Port of ``g1_locomotion_tpu/ops/lin.py``, batch-first:

    K = [[A, B'], [B, C]] = L L',  L = [[L1, 0], [L21, L2]]
    W := L^-1 = [[W1, 0], [-W2 L21 W1, W2]],   K^-1 = W' W

recursing on A and the Schur complement S = C - L21 L21' down to blocks of
at most ``_BASE`` rows. Cholesky needs no pivoting for SPD input and is
backward stable (a naive block Gauss-Jordan / Schur inverse lost all
accuracy at cond(K) ~ 1e4). The combine steps are batched matmuls
(``torch.matmul``); the base case is kernel B1
(``cuda_lin.chol_inverse_base``) for a CUDA tensor and its plain version for
a CPU tensor. Because the batch is explicit, every base call is one launch
over the whole batch.
"""

from __future__ import annotations

import torch

from g1_locomotion_tpu_torch.ops import cuda_lin

_BASE = 30  # base-case block size: 120 -> 60 -> 30, 200 -> 100 -> 50 -> 25


def chol_inverse(K: torch.Tensor) -> torch.Tensor:
    """W = L^-1 for the Cholesky factor of batched SPD K (..., n, n)."""
    n = K.shape[-1]
    if n <= _BASE:
        flat = K.reshape((-1, n, n)).contiguous()
        return cuda_lin.chol_inverse_base(flat).reshape(K.shape)
    h = n // 2
    A = K[..., :h, :h]
    B = K[..., h:, :h]
    C = K[..., h:, h:]
    W1 = chol_inverse(A)
    L21 = B @ W1.mT  # = K21 L1^-T
    S = C - L21 @ L21.mT
    W2 = chol_inverse(S)
    bottom_left = -(W2 @ (L21 @ W1))
    top = torch.cat([W1, K.new_zeros(K.shape[:-2] + (h, n - h))], dim=-1)
    bot = torch.cat([bottom_left, W2], dim=-1)
    return torch.cat([top, bot], dim=-2)


def spd_inverse(K: torch.Tensor) -> torch.Tensor:
    """Inverse of batched SPD K (..., n, n): K^-1 = W' W, W = L^-1."""
    W = chol_inverse(K)
    return W.mT @ W


def spd_solve(K: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve K x = b for SPD K via the matmul inverse (batched); b is
    (..., n) or (..., n, k)."""
    Ki = spd_inverse(K)
    if b.dim() == K.dim() - 1:
        return (Ki @ b[..., None])[..., 0]
    return Ki @ b
