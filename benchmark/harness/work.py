"""Operations and bytes of the program's kernels, from their shapes, and the
card's peaks they are held against.

``b1_work`` is the count of ``chip_smoke.work("chol_inverse_base", ...)``:
the least one launch of B1 (``chol_inv_base_kernel``, W = L^-1 of K = L L'
for a batch of b blocks n x n) must do. Each input byte is read once and
each output byte written once, whatever strides the blocks have.
"""

from __future__ import annotations

from typing import Tuple

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit: HBM3 bandwidth and
# the vector (non-tensor-core) rates; the port's float32 runs in IEEE fp32
# (TF32 off), so the tensor-core rates do not bound it.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def b1_work(b: int, n: int, itemsize: int) -> Tuple[float, float]:
    """(bytes, flops) of one B1 launch over b blocks n x n: K read and W
    written once; Cholesky n^3 / 3 and the triangular inverse n^3 / 3
    multiply-adds."""
    return 2.0 * b * n * n * itemsize, b * 2.0 * n**3 / 3.0


def b1_bound_s(b: int, n: int, dtype: torch.dtype) -> float:
    """The least time the card can take for one B1 launch: the larger of
    bytes over bandwidth and operations over the vector rate."""
    nbytes, flops = b1_work(b, n, torch.empty((), dtype=dtype).element_size())
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
