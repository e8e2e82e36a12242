"""The original controller's imperative MPC class (``srbd_mpc.mpc.MPC``).

Port of ``g1_locomotion_tpu/mpc/api.py``, for code written against the
original's Python API:

    MPC = mpc.MPC(dt=0.04)
    MPC.init_matrices()
    MPC.x0[...] = ...; MPC.x_ref_hor[...] = ...
    u_opt0, x_opt = MPC.update(contact_horizon, c_horizon, p_com_horizon,
                               x_current=MPC.x0, one_rollout=True)

A thin stateful host-side adapter (mutable numpy attributes, as the
original has them) over one :class:`~.solver.MPCSolver` built in
:meth:`MPC.init_matrices`; each update is one B = 1 solve, warm-started
from the previous one's force plan. ``device=None`` takes the card.
"""

from __future__ import annotations

import numpy as np
import torch

from g1_locomotion_tpu_torch._device import require_cuda
from g1_locomotion_tpu_torch.models import srbd
from g1_locomotion_tpu_torch.mpc import solver


class MPC:
    HORIZON_LENGTH = 10  # N

    def __init__(self, dt: float = 0.04, horizon: int = None, dtype=torch.float32,
                 device=None):
        if horizon is not None:
            self.HORIZON_LENGTH = horizon
        self.dt = dt
        self.g = srbd.GRAVITY
        self.x0 = np.zeros((13, 1))
        self.x0[12] = self.g
        self.x_ref_hor = np.zeros((self.HORIZON_LENGTH, 13))
        self.x_ref_hor[:, 12] = self.g
        self._dtype = dtype
        self._device = require_cuda() if device is None else torch.device(device)
        self._cfg = solver.MPCConfig(horizon=self.HORIZON_LENGTH, dt=dt)
        self._solver = None
        self._U_warm = None

    def init_matrices(self) -> None:
        """Build the solver and reset the warm start (the original
        preallocates its matrices here)."""
        like = dict(device=self._device, dtype=self._dtype)
        self._solver = solver.MPCSolver(self._cfg, solver.default_weights(**like),
                                        srbd.default_params(**like))
        self._U_warm = torch.zeros((1, self.HORIZON_LENGTH, 12), **like)

    def _tensor(self, a, shape) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.float64).reshape(shape), dtype=self._dtype,
                            device=self._device)

    def update(self, contact_horizon, c_horizon, p_com_horizon, x_current=None,
               one_rollout: bool = True):
        """One MPC solve; returns (u_opt0 (12,), x_opt (N+1, 13)) as numpy."""
        if not one_rollout:
            # The original's call sites always pass one_rollout=True; the
            # multi-rollout semantics are unknown, so refuse rather than
            # ignore the flag.
            raise NotImplementedError(
                "one_rollout=False is not supported: only the single-rollout "
                "contract of the original controller is implemented")
        if self._solver is None:
            self.init_matrices()
        N = self.HORIZON_LENGTH
        x0 = self._tensor(x_current if x_current is not None else self.x0, (1, 13))
        x_ref = self._tensor(np.asarray(self.x_ref_hor)[:N], (1, N, 13))
        contact = self._tensor(contact_horizon, (1, N, 4))
        c_hor = self._tensor(c_horizon, (1, N, 4, 3))
        p_hor = self._tensor(np.asarray(p_com_horizon)[:, :3], (1, N, 3))
        sol = self._solver(x0, x_ref, contact, c_hor, p_hor, U_warm=self._U_warm)
        self._U_warm = sol.U
        return sol.u0[0].cpu().numpy(), sol.x_horizon[0].cpu().numpy()
