"""Joint-space PD controller, a bring-up utility.

Port of ``g1_locomotion_tpu/utils/pd.py`` (the original controller's
``PD_controller.py``: a per-joint PD for bring-up, not part of the main
pipeline). It settles the robot onto the floor before the MuJoCo bridge
engages the cascade (``engine/mujoco_bridge.py``). Works on tensors of any
shape and device; the gains broadcast against them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PDGains(NamedTuple):
    kp: torch.Tensor  # (nj,) or 0-d
    kd: torch.Tensor  # (nj,) or 0-d


def default_gains(*, device, dtype=torch.float32) -> PDGains:
    """Conservative whole-body bring-up gains (the original PD_controller.py
    uses per-joint values of this order)."""
    return PDGains(kp=torch.tensor(300.0, dtype=dtype, device=device),
                   kd=torch.tensor(10.0, dtype=dtype, device=device))


def pd_torques(gains: PDGains, q_des, q, dq, dq_des=0.0, tau_max=None) -> torch.Tensor:
    """tau = Kp (q_des - q) + Kd (dq_des - dq), clipped to +-tau_max if given."""
    tau = gains.kp * (q_des - q) + gains.kd * (dq_des - dq)
    if tau_max is not None:
        tau = torch.clamp(tau, -tau_max, tau_max)
    return tau
