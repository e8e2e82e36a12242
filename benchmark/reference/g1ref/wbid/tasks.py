"""WBID task and constraint configuration: gains and weights of the stack.

Port of ``g1_locomotion_tpu/wbid/tasks.py``: the declarative spec of the
OpenSoT ``AutoStack`` the reference builds in ``WholeBodyID.setupProblem``
(wbid.py:29-224). Each constant is traced to a wbid.py line in the JAX
package's module, which also explains the choices that depart from it.

Gains are shared by the whole batch (0-d or per-axis tensors);
``WBIDReferences`` carry the batch axis in front of every field.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class WBIDGains(NamedTuple):
    com_kp: torch.Tensor          # (3,) CoM task (wbid.py:55-60)
    com_kd: torch.Tensor          # (3,)
    w_com: torch.Tensor
    base_kp_ang: torch.Tensor     # (3,) base orientation, rows 3:6 (wbid.py:70-75)
    base_kd_ang: torch.Tensor     # (3,)
    w_base: torch.Tensor
    posture_kp: torch.Tensor      # postural task on the non-leg joints (wbid.py:128-134)
    posture_kd: torch.Tensor
    w_posture: torch.Tensor
    w_qddot_reg: torch.Tensor     # acceleration regularization (wbid.py:152)
    angmom_k: torch.Tensor        # angular momentum task (wbid.py:136-142)
    w_angmom: torch.Tensor
    w_tau_reg: torch.Tensor       # torque minimization (wbid.py:170)
    contact_kp: torch.Tensor      # stance tasks (wbid.py:174-176)
    contact_kd: torch.Tensor
    w_contact: torch.Tensor
    swing_kp: torch.Tensor        # (6,) swing tasks (wbid.py:110-115)
    swing_kd: torch.Tensor        # (6,)
    w_swing: torch.Tensor
    w_wrench: torch.Tensor        # per-contact wrench tracking (wbid.py:179-182)
    w_wrench_total: torch.Tensor  # (3,) per-axis net-contact-force tracking
    mu: torch.Tensor              # friction coefficient (wbid.py:17), 0-d or (B,)
    fz_min: torch.Tensor          # stance wrench limits (wbid.py:123-124)
    fz_max: torch.Tensor
    fxy_max: torch.Tensor
    hand_kp: torch.Tensor         # optional hand Cartesian tasks
    hand_kd: torch.Tensor
    w_hand: torch.Tensor
    torso_kp_ang: torch.Tensor    # optional torso-orientation task
    torso_kd_ang: torch.Tensor
    w_torso: torch.Tensor
    qlim_lookahead: torch.Tensor  # joint-limit viability lookahead [s]
    w_posture_legs: torch.Tensor  # optional leg postural task (settle knee guard)
    knee_floor: torch.Tensor      # knee-extension floor [rad] under the guard


_DEFAULTS = dict(
    com_kp=[300.0, 300.0, 300.0],
    com_kd=[90.0, 90.0, 150.0],
    w_com=3.0,
    base_kp_ang=[50.0, 50.0, 100.0],
    base_kd_ang=[250.0, 250.0, 250.0],
    w_base=3.0,
    posture_kp=400.0,
    posture_kd=40.0,
    w_posture=0.4,
    w_qddot_reg=0.005,
    angmom_k=3.0,
    w_angmom=0.3,
    w_tau_reg=1e-8,
    contact_kp=300.0,
    contact_kd=20.0,
    w_contact=4.5,
    swing_kp=[1650.0, 2250.0, 1680.0, 210.0, 210.0, 210.0],
    swing_kd=[30.0, 30.0, 51.0, 21.0, 21.0, 21.0],
    w_swing=2.9,
    w_wrench=0.05,
    w_wrench_total=[25.0, 25.0, 0.0],
    mu=0.8,
    fz_min=10.0,
    fz_max=1000.0,
    fxy_max=1000.0,
    hand_kp=100.0,
    hand_kd=20.0,
    w_hand=1.0,
    torso_kp_ang=60.0,
    torso_kd_ang=15.0,
    w_torso=2.0,
    qlim_lookahead=0.02,
    w_posture_legs=0.0,
    knee_floor=0.15,
)


def default_gains(*, device, dtype=torch.float32) -> WBIDGains:
    return WBIDGains(**{k: torch.tensor(v, dtype=dtype, device=device)
                        for k, v in _DEFAULTS.items()})


class WBIDReferences(NamedTuple):
    """Per-tick references (the reference's ``setReference``,
    wbid.py:232-297, and the gait FSM's task activity), batched."""

    com_pos: torch.Tensor        # (B, 3) from the MPC's x_opt1[3:6]
    com_vel: torch.Tensor        # (B, 3)
    com_acc: torch.Tensor        # (B, 3) feedforward sum(F)/m + g
    base_R: torch.Tensor         # (B, 3, 3) desired base orientation
    base_angvel: torch.Tensor    # (B, 3)
    base_angacc: torch.Tensor    # (B, 3)
    posture_q: torch.Tensor      # (B, nj) posture reference
    contact_pos: torch.Tensor    # (B, 2, 3) stance-foot targets
    contact_R: torch.Tensor      # (B, 2, 3, 3)
    swing_pos: torch.Tensor      # (B, 2, 3) swing trajectory
    swing_vel: torch.Tensor      # (B, 2, 3)
    swing_acc: torch.Tensor      # (B, 2, 3)
    swing_R: torch.Tensor        # (B, 2, 3, 3)
    f_des: torch.Tensor          # (B, 4, 3) MPC contact forces
    contact_active: torch.Tensor  # (B, 2) 1 = foot in stance
    angmom_L: torch.Tensor       # (B, 3) desired centroidal angular momentum
    angmom_Ldot: torch.Tensor    # (B, 3) its rate feedforward
    # Optional tasks: None leaves them out of the QP altogether.
    hand_pos: Optional[torch.Tensor] = None            # (B, 2, 3) hand targets
    torso_R: Optional[torch.Tensor] = None             # (B, 3, 3) torso target
    posture_legs_scale: Optional[torch.Tensor] = None  # (B,) leg posture fade-in
