"""Footstep planning: landing positions for the swing foot.

Port of ``g1_locomotion_tpu/gait/footsteps.py``, batched: the
:class:`FootstepConfig` fields are 0-d (shared) or ``(B,)`` tensors, the
states ``(B, ...)``.

* :func:`fixed_plan`: a straight-line forward plan with a constant step
  length (the walking demo);
* :func:`raibert`: the velocity-tracking heuristic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FootstepConfig(NamedTuple):
    step_length: torch.Tensor   # m forward per step
    step_width: torch.Tensor    # lateral half-distance between the feet
    raibert_gain: torch.Tensor  # feedback gain on the velocity error (raibert)
    dcm_scale: torch.Tensor     # lateral placement gain on the touchdown DCM error
    dcm_scale_x: torch.Tensor   # sagittal placement gain; NaN follows dcm_scale
    final_widen: torch.Tensor   # terminal stance widening of the last two landings [m]
    dcm_err_gain: torch.Tensor  # state-scheduled lateral DCM gain [1/m] (plan_extras)
    dcm_corr_max: torch.Tensor  # cap on the scheduled lateral correction [m]


_DEFAULTS = dict(step_length=0.10, step_width=0.12, raibert_gain=0.03, dcm_scale=1.0,
                 dcm_scale_x=float("nan"), final_widen=0.0, dcm_err_gain=0.0,
                 dcm_corr_max=1.0)


def default_footsteps(*, device, dtype=torch.float32) -> FootstepConfig:
    """The reference's defaults, 0-d tensors (shared by the batch)."""
    return FootstepConfig(**{k: torch.tensor(v, dtype=dtype, device=device)
                             for k, v in _DEFAULTS.items()})


def dcm_scale_sagittal(cfg: FootstepConfig) -> torch.Tensor:
    """Sagittal DCM-placement gain: dcm_scale_x, or dcm_scale where NaN."""
    return torch.where(torch.isnan(cfg.dcm_scale_x), cfg.dcm_scale, cfg.dcm_scale_x)


def fixed_plan(cfg: FootstepConfig, step_idx: torch.Tensor, swing_is_left: torch.Tensor,
               x0_foot: torch.Tensor) -> torch.Tensor:
    """(B, 3) landing (x, y, 0) of a straight-line walk's step step_idx (B,):
    step k advances the swinging foot to start + (k // 2 + 1) step_length;
    x0_foot (B, 2) is the foot's x, y at gait start."""
    advance = (torch.floor(step_idx / 2.0) + 1.0) * cfg.step_length
    x = x0_foot[..., 0] + advance
    y = torch.where(swing_is_left, cfg.step_width, -cfg.step_width)
    x, y = torch.broadcast_tensors(x, y)
    return torch.stack([x, y, torch.zeros_like(x)], dim=-1)


def raibert(cfg: FootstepConfig, com_pos: torch.Tensor, com_vel: torch.Tensor,
            v_cmd: torch.Tensor, swing_is_left: torch.Tensor,
            stance_duration: torch.Tensor) -> torch.Tensor:
    """(B, 3) Raibert touchdown p = p_com + v T/2 + k (v - v_cmd), offset
    laterally by the step width."""
    p_xy = (com_pos[..., :2] + com_vel[..., :2] * (stance_duration / 2.0)[..., None]
            + cfg.raibert_gain[..., None] * (com_vel[..., :2] - v_cmd))
    y_off = torch.where(swing_is_left, cfg.step_width, -cfg.step_width)
    return torch.stack([p_xy[..., 0], p_xy[..., 1] + y_off, torch.zeros_like(p_xy[..., 0])],
                       dim=-1)
