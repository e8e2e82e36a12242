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

Nothing is copied on the way: W is allocated once, as zeros (the block above
the diagonal of every level is zero), each level works on views of K and of
W, the base case reads its block of K and writes its block of W where they
lie (B1 takes strided blocks), and a level writes only its bottom-left
block.
"""

from __future__ import annotations

import torch

from benchmark.reference.g1ref.ops import plain_lin as cuda_lin

_BASE = 30  # base-case block size: 120 -> 60 -> 30, 200 -> 100 -> 50 -> 25


def chol_inverse(K: torch.Tensor) -> torch.Tensor:
    """W = L^-1 for the Cholesky factor of batched SPD K (..., n, n)."""
    n = K.shape[-1]
    flat = K.reshape((-1, n, n))
    W = torch.zeros_like(flat, memory_format=torch.contiguous_format)
    _chol_inverse_into(flat, W)
    return W.reshape(K.shape)


def _chol_inverse_into(K: torch.Tensor, W: torch.Tensor) -> None:
    """Write L^-1 of K (B, n, n) into the lower triangle of W (B, n, n), whose
    block above the diagonal blocks is zero already. Both may be views."""
    n = K.shape[-1]
    if n <= _BASE:
        cuda_lin.chol_inverse_base(K, out=W)
        return
    h = n // 2
    W1, W2 = W[:, :h, :h], W[:, h:, h:]
    _chol_inverse_into(K[:, :h, :h], W1)
    L21 = K[:, h:, :h] @ W1.mT  # = K21 L1^-T
    S = K[:, h:, h:] - L21 @ L21.mT
    _chol_inverse_into(S, W2)
    torch.neg(W2 @ (L21 @ W1), out=W[:, h:, :h])


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
