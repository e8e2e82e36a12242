"""WBID solve and inverse-dynamics torque extraction, batched.

Port of ``g1_locomotion_tpu/wbid/solver.py``. The tick mirrors the
reference (updateModel -> setReference -> solveQP -> getInverseDynamics,
wbid.py:227-324) as one function over a batch: the stack's QP through the
shared ADMM (:mod:`benchmark.reference.g1ref.ops.qp`), then
tau = RNEA(q, v, qddot) - sum_i Jc_i' f_i, the actuated part clipped to the
motors' limits (wbid.py:316-324, ros_run_simulation.py:413-417).

Which kernels a tick launches follows from ``WBIDConfig.qp``: the default
(matmul inverses) ends every SPD inverse in kernel B1; the serving
configuration (``polish_kernel=True``) runs B2, B3 and B4; the
factorization path (``matmul_inverse=False``, the validated walk and the
strict hierarchy) runs none.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from benchmark.reference.g1ref.models import dynamics as dyn
from benchmark.reference.g1ref.models.robot import RobotModel
from benchmark.reference.g1ref.ops import qp as qplib
from benchmark.reference.g1ref.wbid.stack import NF, StackIndices, build_qp
from benchmark.reference.g1ref.wbid.tasks import WBIDGains, WBIDReferences


class WBIDConfig(NamedTuple):
    dt: float = 0.001  # control tick (ros_run_simulation.py:172)
    qp: qplib.QPConfig = qplib.QPConfig(iters=50, scaling_iters=3, rho=0.1, rho_segments=2)
    # OpenSoT-style strict priority levels (wbid/ihqp.py) instead of the
    # reference's single weighted sum (wbid.py:167-182).
    strict_hierarchy: bool = False
    # The stack's assembly with fewer operations (stack.build_qp fast=True):
    # the same QP, the serving tick's lever (its B = 1 tick is launch-bound).
    fast_stack: bool = False


class WBIDSolution(NamedTuple):
    qddot: torch.Tensor            # (B, nv)
    forces: torch.Tensor           # (B, NF, 3) contact forces
    tau: torch.Tensor              # (B, nj) actuated torques
    base_wrench_res: torch.Tensor  # (B, 6) dynamic-feasibility residual (~0)
    pri_res: torch.Tensor          # (B,)
    dua_res: torch.Tensor          # (B,)


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (M @ x[..., None])[..., 0]


def torques(model: RobotModel, q, v, x, Jc_T, body_X=None):
    """(tau_full (B, nv), the actuated torques clipped to tau_max (B, nj))
    for the QP's solution x = [qddot, f]."""
    nv = model.nv
    tau_full = dyn.rnea(model, q, v, x[:, :nv], body_X=body_X) - _mv(Jc_T, x[:, nv:])
    return tau_full, torch.clamp(tau_full[:, 6:], min=-model.tau_max, max=model.tau_max)


def solve(model: RobotModel, idx: StackIndices, cfg: WBIDConfig, gains: WBIDGains,
          q: torch.Tensor, v: torch.Tensor, refs: WBIDReferences, body_X=None) -> WBIDSolution:
    """One WBID tick for a batch: q (B, nq), v (B, nv), refs batched."""
    if cfg.strict_hierarchy:
        from benchmark.reference.g1ref.wbid.ihqp import solve_ihqp

        return solve_ihqp(model, idx, cfg, gains, q, v, refs, body_X=body_X)
    H, g, C, l, u, (M, h, Jc_T) = build_qp(model, idx, gains, q, v, refs, cfg.dt,
                                           body_X=body_X, fast=cfg.fast_stack)
    sol = qplib.solve_qp(H, g, C, l, u, cfg=cfg.qp)
    # The QP's torque rows hold within the ADMM's tolerance; a real motor
    # saturates at its limit, hence the clip.
    tau_full, tau = torques(model, q, v, sol.x, Jc_T, body_X)
    nv = model.nv
    return WBIDSolution(
        qddot=sol.x[:, :nv],
        forces=sol.x[:, nv:].reshape(-1, NF, 3),
        tau=tau,
        base_wrench_res=tau_full[:, 0:6],
        pri_res=sol.pri_res,
        dua_res=sol.dua_res,
    )


def _tensor_fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)}


class ModelModule(nn.Module):
    """A module that holds a robot model and its :class:`StackIndices`: their
    tensors are buffers (so ``.to(device)`` moves them), and ``model`` and
    ``idx`` are rebuilt from the buffers whenever the module moves, and kept:
    their index tensors are made once per device."""

    def __init__(self, model: RobotModel, idx: Optional[StackIndices] = None):
        super().__init__()
        self._static = (model, idx if idx is not None else StackIndices.from_model(model))
        for prefix, obj in (("model_", self._static[0]), ("idx_", self._static[1])):
            for name, t in _tensor_fields(obj).items():
                self.register_buffer(prefix + name, t)

    def _rebuild(self) -> None:
        model, idx = self._static
        self.model = dataclasses.replace(
            model, _index_cache={},
            **{k: getattr(self, "model_" + k) for k in _tensor_fields(model)})
        self.idx = dataclasses.replace(
            idx, **{k: getattr(self, "idx_" + k) for k in _tensor_fields(idx)})

    def _apply(self, fn, recurse=True):
        out = super()._apply(fn, recurse)
        self._rebuild()
        return out


class WBIDSolver(ModelModule):
    """The WBID tick as a module: the robot model, the stack's constant blocks
    and the gains are buffers; :func:`solve` runs with a fixed
    :class:`WBIDConfig`."""

    def __init__(self, cfg: WBIDConfig, model: RobotModel, gains: WBIDGains,
                 idx: Optional[StackIndices] = None):
        super().__init__(model, idx)
        self.cfg = cfg
        self._gain_names = WBIDGains._fields
        for name in self._gain_names:
            self.register_buffer("gain_" + name, torch.as_tensor(getattr(gains, name)))
        self._rebuild()

    @property
    def gains(self) -> WBIDGains:
        return WBIDGains(**{k: getattr(self, "gain_" + k) for k in self._gain_names})

    def forward(self, q: torch.Tensor, v: torch.Tensor, refs: WBIDReferences,
                body_X=None) -> WBIDSolution:
        return solve(self.model, self.idx, self.cfg, self.gains, q, v, refs, body_X=body_X)
