"""Typed message contracts: the g1_msgs equivalents as dataclasses of tensors.

Port of ``g1_locomotion_tpu/msgs.py``. The original controller serializes
four ROS message types: ``State`` (the 13-dim SRBD state), ``ContactPoint``
(position, force, active), ``SRBD_state`` (a horizon of states, the
contacts and the landing position) and ``Feet_reference``. Here they cross
no wire; their shapes and field order are kept so that logs of the original
convert without loss. Every field may carry leading batch dimensions in
front of the shapes noted.

Field order, as the original's:

* the SRBD state vector: orientation (rpy), position, angular velocity,
  linear velocity, gravity;
* contacts: L-heel, L-toe, R-heel, R-toe.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from g1_locomotion_tpu_torch.engine.tick import srbd_state_from_wholebody
from g1_locomotion_tpu_torch.models import robot as rb
from g1_locomotion_tpu_torch.wbid.stack import StackIndices

CONTACT_NAMES: Tuple[str, ...] = (
    "left_foot_line_contact_lower",
    "left_foot_line_contact_upper",
    "right_foot_line_contact_lower",
    "right_foot_line_contact_upper",
)


@dataclasses.dataclass(frozen=True)
class State:
    """g1_msgs/State: one 13-dim SRBD state sample."""

    orientation: torch.Tensor       # (..., 3) rpy [rad]
    position: torch.Tensor          # (..., 3) CoM [m]
    angular_velocity: torch.Tensor  # (..., 3) [rad/s]
    linear_velocity: torch.Tensor   # (..., 3) [m/s]
    gravity: torch.Tensor           # (...) [m/s^2], -9.80665

    def to_vector(self) -> torch.Tensor:
        """Pack into the (..., 13) state layout."""
        return torch.cat([self.orientation, self.position, self.angular_velocity,
                          self.linear_velocity, self.gravity[..., None]], dim=-1)

    @staticmethod
    def from_vector(x: torch.Tensor) -> "State":
        return State(orientation=x[..., 0:3], position=x[..., 3:6],
                     angular_velocity=x[..., 6:9], linear_velocity=x[..., 9:12],
                     gravity=x[..., 12])


@dataclasses.dataclass(frozen=True)
class ContactPoint:
    """g1_msgs/ContactPoint: position, force and active flag (the name is
    static by index, CONTACT_NAMES)."""

    position: torch.Tensor  # (..., 3)
    force: torch.Tensor     # (..., 3)
    active: torch.Tensor    # (...) 0 / 1


@dataclasses.dataclass(frozen=True)
class SRBDState:
    """g1_msgs/SRBD_state: the /srbd_current and /mpc_solution payload."""

    states_horizon: torch.Tensor     # (..., H, 13) stacked State vectors
    contact_positions: torch.Tensor  # (..., 4, 3)
    contact_forces: torch.Tensor     # (..., 4, 3)
    contact_active: torch.Tensor     # (..., 4)
    landing_position: torch.Tensor   # (..., 3)


@dataclasses.dataclass(frozen=True)
class FeetReference:
    """g1_msgs/Feet_reference: left / right foot position references."""

    left: torch.Tensor   # (..., 3)
    right: torch.Tensor  # (..., 3)


def srbd_current_from_engine(model, q: torch.Tensor, v: torch.Tensor, forces: torch.Tensor,
                             body_X=None) -> SRBDState:
    """The /srbd_current message of a batch of engine states: q (B, nq),
    v (B, nv), forces (B, 4, 3) or (B, 12); fields (B, ...)."""
    if body_X is None:
        body_X = rb.fk(model, q)
    idx = StackIndices.from_model(model)
    x = srbd_state_from_wholebody(model, q, v, body_X)
    cpos = torch.stack([rb.frame_pose(model, body_X, f).p for f in idx.contacts], dim=1)
    B = x.shape[0]
    return SRBDState(
        states_horizon=x[:, None, :], contact_positions=cpos,
        contact_forces=forces.reshape(B, 4, 3), contact_active=x.new_ones((B, 4)),
        landing_position=x.new_zeros((B, 3)),
    )

