"""Strict-hierarchy WBID solve: OpenSoT's multi-level ``/`` operator, batched.

Port of ``g1_locomotion_tpu/wbid/ihqp.py``. Level k is solved as a full QP
whose cost adds the earlier levels' task rows pinned to their achieved
values with a large weight ratio (``PIN_RATIO``):

    x_k* = argmin  sum_{i in level k} w_i ||A_i x - b_i||^2
                 + pin * sum_{j < k} w_j ||A_j x - (A_j x_{k-1}*)||^2
           s.t.   l <= C x <= u

a lexicographic optimization to O(1 / pin) with static shapes. Levels:
0 = feet (contact / swing), 1 = CoM / base / momentum / wrench tracking,
2 = posture / regularization. Each level's QP runs on the factorization
path (``IHQP_QP``, ``matmul_inverse=False``), so this solve launches no
kernel of ``ops/cuda_lin``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.g1ref.ops import qp as qplib
from benchmark.reference.g1ref.wbid.solver import WBIDSolution, torques
from benchmark.reference.g1ref.wbid.stack import NF, build_qp

N_LEVELS = 3
PIN_RATIO = 1e3  # lexicographic to ~0.1%
REG_QDD = 1e-2   # per-level qddot regularizer (OpenSoT's per-level eps)
REG_F = 1e-8     # forces carry gravity: no meaningful pull

# Not a hot path (an offline capability; the reference runs one level,
# wbid.py:224): each level is solved tightly so that pins do not collect
# ADMM noise.
IHQP_QP = qplib.QPConfig(iters=150, scaling_iters=3, rho=0.1, rho_segments=4,
                         matmul_inverse=False, polish_rounds=3)


def _row_mask(rows: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """(R,) bool tensor of a static row mask, made from its runs on the
    device (no copy from the host)."""
    edges = np.flatnonzero(np.diff(rows.astype(np.int8))) + 1
    runs = np.split(rows, edges)
    return torch.cat([torch.full((len(r),), bool(r[0]), dtype=torch.bool, device=like.device)
                      for r in runs])


def solve_ihqp(model, idx, cfg, gains, q, v, refs, body_X=None) -> WBIDSolution:
    """Strict-hierarchy WBID solve (drop-in for :func:`wbid.solver.solve`)."""
    H, g, C, l, u, (M, h, Jc_T), (A_all, b_all, w_all, levels) = build_qp(
        model, idx, gains, q, v, refs, cfg.dt, body_X=body_X, with_blocks=True)
    B, nx = A_all.shape[0], A_all.shape[-1]
    nv = model.nv

    x = q.new_zeros((B, nx))
    pri = q.new_zeros((B,))
    dua = q.new_zeros((B,))
    reg = torch.cat([q.new_full((nv,), REG_QDD), q.new_full((nx - nv,), REG_F)])
    solved = np.zeros(levels.shape[0], dtype=bool)
    for k in range(N_LEVELS):
        level = levels == k
        if not level.any():
            continue
        # The current level at its weights; the earlier ones pinned to what
        # they achieved.
        lvl_t, solved_t = _row_mask(level, q), _row_mask(solved, q)
        w_tot = (torch.where(lvl_t, w_all, 0.0)
                 + torch.where(solved_t, w_all * PIN_RATIO, 0.0))
        b_k = torch.where(solved_t, (A_all @ x[..., None])[..., 0], b_all)
        AW = A_all * w_tot[..., None]
        H_k = AW.mT @ A_all + torch.diag(reg)
        g_k = -(AW.mT @ b_k[..., None])[..., 0]
        sol = qplib.solve_qp(H_k, g_k, C, l, u, cfg=IHQP_QP)
        x = sol.x
        pri = torch.maximum(pri, sol.pri_res)
        dua = torch.maximum(dua, sol.dua_res)
        solved = solved | level

    tau_full, tau = torques(model, q, v, x, Jc_T, body_X)
    return WBIDSolution(
        qddot=x[:, :nv],
        forces=x[:, nv:].reshape(-1, NF, 3),
        tau=tau,
        base_wrench_res=tau_full[:, 0:6],
        pri_res=pri,
        dua_res=dua,
    )
