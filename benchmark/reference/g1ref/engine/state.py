"""Whole-body state container and the standing configuration.

Port of ``g1_locomotion_tpu/engine/state.py``, batch-first. The standing
configuration reproduces the reference's ``q_init``
(g1_mujoco_sim/src/config.py:2-39: base z = 0.793 - 0.113 = 0.68, hips
-0.6, knees 1.2, ankles -0.6) in the scalar-first quaternion layout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.g1ref.models.robot import RobotModel

# Joint name -> standing angle; every other joint at zero.
_STAND_ANGLES = {
    "left_hip_pitch_joint": -0.6,
    "left_knee_joint": 1.2,
    "left_ankle_pitch_joint": -0.6,
    "right_hip_pitch_joint": -0.6,
    "right_knee_joint": 1.2,
    "right_ankle_pitch_joint": -0.6,
}

_STAND_BASE_Z = 0.793 - 0.113  # = 0.68, reference config.py:6


def q_init_standing(model: RobotModel, batch: int = 1, dtype=None) -> torch.Tensor:
    """q = [pos(3), quat wxyz(4), joints(nj)], standing, (batch, nq)."""
    qj = [_STAND_ANGLES.get(name, 0.0) for name in model.joint_names]
    q = torch.tensor([0.0, 0.0, _STAND_BASE_Z, 1.0, 0.0, 0.0, 0.0] + qj,
                     dtype=dtype or model.dtype, device=model.device)
    return q.expand(batch, -1).clone()


class WholeBodyState(NamedTuple):
    """Configuration and generalized velocity (model layout), batched."""

    q: torch.Tensor  # (B, nq)
    v: torch.Tensor  # (B, nv)


def standing_state(model: RobotModel, batch: int = 1, dtype=None) -> WholeBodyState:
    q = q_init_standing(model, batch, dtype)
    return WholeBodyState(q=q, v=q.new_zeros((batch, model.nv)))
