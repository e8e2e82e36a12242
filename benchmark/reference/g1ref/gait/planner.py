"""Horizon planner: gait state and SRBD measurement -> the MPC's inputs.

Port of ``g1_locomotion_tpu/gait/planner.py``, batched: the states are
``(B, ...)``, the gait and footstep configurations 0-d or ``(B,)`` per
field, the plan ``(B, N, ...)``. The planning half of the reference's MPC
node: footstep placement (DCM feedback against the periodic LIPM orbits of
:mod:`.schedule` on both axes), the horizon's contact schedule and contact
positions, the feet-relative (receding) CoM reference and the swing-limb
momentum preview. The JAX module documents why each piece is as it is; the
order of every floating-point operation follows it, because closed-loop
walking flips on rounding-level changes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from benchmark.reference.g1ref._device import const
from benchmark.reference.g1ref.gait import footsteps as fs
from benchmark.reference.g1ref.gait import schedule as gs
from benchmark.reference.g1ref.gait import swing as sw
from benchmark.reference.g1ref.gait.schedule import clip
from benchmark.reference.g1ref.models.srbd import GRAVITY

# Heel / toe frame offsets from the foot center (g1_23dof.urdf:288,293).
HEEL_TOE_XY = ((-0.05, 0.0, 0.0), (0.12, 0.0, 0.0))
# Their mean sits 3.5 cm ahead of the foot center: sagittal anchors subtract it.
_HT_X_OFF = sum(p[0] for p in HEEL_TOE_XY) / len(HEEL_TOE_XY)


class MPCPlan(NamedTuple):
    """Everything the MPC solve needs, plus bookkeeping for the engine."""

    x_ref: torch.Tensor         # (B, N, 13) state reference horizon
    contact_hor: torch.Tensor   # (B, N, 4) 0/1 contact schedule
    c_hor: torch.Tensor         # (B, N, 4, 3) horizon contact positions
    p_ref: torch.Tensor         # (B, N, 3) CoM position reference
    landing: torch.Tensor       # (B, 3) planned touchdown point (foot center)
    landing_mask: torch.Tensor  # (B, N, 4) 1 where a contact sits at the landing
    stance_y: torch.Tensor      # (B,) stance-foot y (for separation clips)
    swing_is_left: torch.Tensor  # (B,) bool
    hdot_geom: torch.Tensor     # (B, N, 3) swing-limb geometric r x a preview


def clip_landing_y(y_land, stance_y, swing_is_left):
    """Foot-separation clip: the landing 8 cm to 45 cm from the stance foot,
    on the swing side."""
    return torch.where(swing_is_left,
                       clip(y_land, stance_y + 0.08, stance_y + 0.45),
                       clip(y_land, stance_y - 0.45, stance_y - 0.08))


def _col(x: torch.Tensor) -> torch.Tensor:
    return x[..., None]


def _on(value: Union[torch.Tensor, float], like: torch.Tensor) -> torch.Tensor:
    """`value` as a tensor of `like`'s dtype and device; a number becomes a
    0-d tensor filled on the device (torch.as_tensor would copy it from the
    host, which makes the host wait for the card)."""
    if isinstance(value, torch.Tensor):
        return value.to(like.dtype)
    return like.new_full((), value)


def plan_horizon(
    gait: gs.GaitConfig,
    steps: fs.FootstepConfig,
    v_cmd: torch.Tensor,       # (B, 2) or (2,) commanded planar velocity
    x0: torch.Tensor,          # (B, 13) measured SRBD state
    cpos: torch.Tensor,        # (B, 4, 3) contact positions (LH, LT, RH, RT)
    gait_clock: torch.Tensor,  # (B,) gated gait time
    N: int,
    dt_mpc: float,
    com_height: float,
    hold: Union[torch.Tensor, float] = 0.0,  # (B,) 1 while the gate pauses the clock
    prev_landing: Optional[torch.Tensor] = None,  # (B, 3) landing of the last replan
    lock_flag: Union[torch.Tensor, float] = 0.0,  # (B,) 1 past the landing lock
    swing_start: Optional[torch.Tensor] = None,  # (B, 2, 3) lift-off positions per foot
    z_apex: float = 0.05,      # swing apex height of the momentum preview
    plan_extras: bool = False,  # the reference's round-5 mechanisms (static gate)
) -> MPCPlan:
    dtype = x0.dtype
    hold = _on(hold, x0)
    v_cmd = v_cmd.expand(x0.shape[0], 2)

    contact_hor = gs.contact_horizon(gait, gait_clock, N, dt_mpc)
    step_idx, _, swing_is_left, _ = gs.phase_info(gait, gait_clock)

    if plan_extras:
        # Pre-stop deceleration: v_cmd ramps to zero over the gait's last
        # pre_stop_s, as every consumer below sees it.
        t_end_ps = gait.start_time + gait.n_steps * (
            gait.swing_duration + gait.double_support_duration)
        ps_factor = torch.where(
            gait.pre_stop_s > 0,
            clip((t_end_ps - gait_clock) / torch.clamp(gait.pre_stop_s, min=1e-6), 0.0, 1.0),
            1.0)
        v_cmd = v_cmd * _col(ps_factor)
    vx, vy = v_cmd[:, 0], v_cmd[:, 1]

    stance_mask = torch.where(_col(swing_is_left), const((0.0, 0.0, 1.0, 1.0), x0),
                              const((1.0, 1.0, 0.0, 0.0), x0))  # (B, 4)
    p_sy = torch.sum(stance_mask * cpos[..., 1], dim=-1) / torch.sum(stance_mask, dim=-1)
    # Stance ANKLE x (contact mean minus the heel / toe asymmetry).
    p_sx = torch.sum(stance_mask * cpos[..., 0], dim=-1) / torch.sum(stance_mask, dim=-1) \
        - _HT_X_OFF
    half = gait.swing_duration + gait.double_support_duration
    omega0 = torch.sqrt(const(-GRAVITY, x0) / com_height)
    W = steps.step_width
    T_gait = gait.n_steps * half
    t_in_step = clip(gait_clock - gait.start_time - step_idx * half, 0.0, None)
    in_step = (step_idx >= 0) & (step_idx < gait.n_steps)

    # Feet-relative (receding) anchoring; see the reference.
    line_y_gait = p_sy + torch.where(swing_is_left, W, -W)
    c0 = 0.5 * vx * half
    ramp_x_gait = p_sx - c0 + vx * t_in_step
    centroid = torch.mean(cpos, dim=-2)
    tau_now = gait_clock - gait.start_time
    s_blend = clip((tau_now - T_gait - 0.5) / torch.clamp(gait.settle_blend_s, min=1e-3),
                   0.0, 1.0)
    stand_x = torch.where(gait.n_steps < 0.5, centroid[:, 0],
                          centroid[:, 0] - _HT_X_OFF + s_blend * _HT_X_OFF)
    line_y = torch.where(in_step, line_y_gait, centroid[:, 1])
    ramp_x = torch.where(in_step, ramp_x_gait, stand_x)

    # Lateral placement: DCM feedback against the mirror-periodic orbit.
    xi_rel = (x0[:, 4] + (x0[:, 10] - vy) / omega0) - line_y
    xi_pred = gs.predict_touchdown_dcm(gait, omega0, W, xi_rel, t_in_step, swing_is_left)
    xi_nom = gs.touchdown_dcm_nominal(gait, omega0, W, swing_is_left)
    w_land = W + steps.final_widen * clip(step_idx - (gait.n_steps - 2.0) + 1.0, 0.0, 1.0)
    e_xi = xi_pred - xi_nom
    if plan_extras:
        eff_scale = steps.dcm_scale + steps.dcm_err_gain * torch.abs(e_xi)
        corr_y = clip(eff_scale * e_xi, -steps.dcm_corr_max, steps.dcm_corr_max)
    else:
        corr_y = steps.dcm_scale * e_xi
    y_land = line_y + torch.where(swing_is_left, w_land, -w_land) + corr_y
    y_land = clip_landing_y(y_land, p_sy, swing_is_left)

    # Sagittal placement: one nominal step ahead of the stance foot plus the
    # same DCM feedback.
    xi_rel_x = (x0[:, 3] + (x0[:, 9] - vx) / omega0) - ramp_x
    xi_pred_x = gs.predict_touchdown_dcm_x(gait, omega0, vx, xi_rel_x, t_in_step)
    xi_nom_x = gs.touchdown_dcm_nominal_x(gait, omega0, vx)
    x_land = (ramp_x + vx * (half - t_in_step) + c0
              + fs.dcm_scale_sagittal(steps) * (xi_pred_x - xi_nom_x))
    landing = torch.stack([x_land, y_land, torch.zeros_like(x_land)], dim=-1)
    if prev_landing is not None:
        lock = _on(lock_flag, x0)
        landing = torch.where(_col(lock > 0.5), prev_landing, landing)

    # Horizon contact positions: stance contacts where they are; the swing
    # side's switch to the landing for the knots after touchdown.
    contact_z = torch.mean(cpos[..., 2], dim=-1)
    landing_pts = landing[:, None, :] + const(HEEL_TOE_XY, x0)  # (B, 2, 3)
    landing_pts = torch.cat([landing_pts[..., :2], contact_z[:, None, None].expand(-1, 2, 1)],
                            dim=-1)
    swing_end = (gait.start_time + step_idx * half + gait.double_support_duration
                 + gait.swing_duration)
    ts = _col(gait_clock) + dt_mpc * torch.arange(N, dtype=dtype, device=x0.device)  # (B, N)
    use_landing = (ts >= _col(swing_end)) & _col(in_step)
    mask_L = use_landing & _col(swing_is_left)
    mask_R = use_landing & _col(~swing_is_left)
    cols = []
    for side, mask in ((0, mask_L), (1, mask_R)):
        for i in range(2):  # heel, toe
            cols.append(torch.where(mask[..., None], landing_pts[:, None, i],
                                    cpos[:, None, 2 * side + i]))
    c_hor = torch.stack(cols, dim=-2)  # (B, N, 4, 3)
    landing_mask = torch.stack([mask_L, mask_L, mask_R, mask_R], dim=-1).to(dtype)

    # Reference horizon: the feet-anchored ramp plus the periodic orbits.
    ks = torch.arange(1, N + 1, dtype=dtype, device=x0.device)
    ts_ref = _col(gait_clock) + dt_mpc * ks  # (B, N)
    y_orb, vy_orb = gs.lateral_orbit_reference(gait, ts_ref, omega0, W)
    ts_all = torch.cat([_col(gait_clock), ts_ref], dim=-1)
    x_orb_all, vx_orb_all = gs.sagittal_orbit_reference(gait, ts_all, omega0, vx)
    x_orb_now, x_orb = x_orb_all[:, 0], x_orb_all[:, 1:]
    vx_orb = vx_orb_all[:, 1:]
    t_end = gait.start_time + T_gait
    adv = clip(torch.minimum(ts_ref, _col(t_end))
               - _col(torch.maximum(gait_clock, gait.start_time)), 0.0, None)
    if plan_extras:
        # Sagittal stop ramp (gait.stop_ramp_s > 0).
        in_walk = _col(gait.n_steps > 0.5)
        stop = _col(gait.stop_ramp_s)
        R_stop = torch.clamp(stop, min=1e-6)
        s_stop_k = clip((ts_ref - _col(t_end)) / R_stop, 0.0, 1.0)
        s_stop_now = clip((_col(torch.maximum(gait_clock, gait.start_time)) - _col(t_end))
                          / R_stop, 0.0, 1.0)

        def decel_pos(s):
            return stop * (s - 0.5 * s * s)

        adv = adv + torch.where(in_walk, decel_pos(s_stop_k) - decel_pos(s_stop_now), 0.0)
        after = in_walk & (ts_ref >= _col(t_end))
        vx_tail = torch.where(after, _col(vx) * (1.0 - s_stop_k) * torch.sign(stop), 0.0)
    gait_elapsed = clip(ts_ref - _col(gait.start_time), 0.0, _col(T_gait))
    in_gait_k = (gait_elapsed > 0.0) & (gait_elapsed < _col(T_gait))
    recede = in_step & (hold < 0.5)
    x_anchor = torch.where(recede, x0[:, 3] - x_orb_now, ramp_x)
    x_ref_line = _col(x_anchor) + _col(vx) * adv + x_orb
    vx_in = torch.where(in_gait_k, _col(vx), 0.0)
    vx_ref = vx_in + vx_tail + vx_orb if plan_extras else vx_in + vx_orb
    hold_k = _col(hold) if hold.dim() else hold
    y_ref = _col(line_y) + _col(vy) * adv + _col(gait.sway_gain) * (
        y_orb + hold_k * vy_orb / omega0)
    p_ref = torch.stack([x_ref_line, y_ref, torch.full_like(x_ref_line, com_height)], dim=-1)

    # Swing-limb momentum preview: geometric r x a of the swing foot over
    # this step's swing window, from the nominal closed-form profile.
    sw_sel = torch.where(_col(swing_is_left), const((1.0, 1.0, 0.0, 0.0), x0),
                         const((0.0, 0.0, 1.0, 1.0), x0))
    p_sw_now = torch.sum(sw_sel[..., None] * cpos, dim=-2) / 2.0
    if swing_start is None:
        p_start_sw = p_sw_now
    else:
        p_start_sw = torch.where(_col(swing_is_left), swing_start[:, 0], swing_start[:, 1])
    swing_begin = gait.start_time + step_idx * half + gait.double_support_duration
    in_swing_k = (ts >= _col(swing_begin)) & (ts < _col(swing_end)) & _col(in_step)
    prog_k = clip((ts - _col(swing_begin)) / _col(gait.swing_duration), 0.0, 1.0)
    sp = sw.SwingParams(p_start=p_start_sw[:, None], p_end=landing[:, None], z_apex=z_apex)
    pos_k, _, acc_k = sw.evaluate(sp, prog_k, _col(gait.swing_duration))
    hdot_geom = torch.linalg.cross(pos_k - p_ref, acc_k, dim=-1) * in_swing_k[..., None].to(dtype)
    if plan_extras:
        vy_tail = torch.where(after, _col(vy) * (1.0 - s_stop_k) * torch.sign(stop), 0.0)
        vy_in = torch.where(in_gait_k, _col(vy), 0.0) + vy_tail
    else:
        vy_in = torch.where(in_gait_k, _col(vy), 0.0)
    vy_ref = (vy_in + _col(gait.sway_gain) * vy_orb) * (1.0 - hold_k)
    zeros = torch.zeros_like(x_ref_line)
    # Stance-side torso lean reference (roll toward the stance foot).
    roll = -_col(gait.lean_gain) * y_orb / _col(torch.clamp(W, min=1e-3))
    g = torch.full_like(x_ref_line, GRAVITY)
    x_ref = torch.stack([roll, zeros, zeros, p_ref[..., 0], p_ref[..., 1], p_ref[..., 2],
                         zeros, zeros, zeros, vx_ref, vy_ref, zeros, g], dim=-1)

    return MPCPlan(x_ref=x_ref, contact_hor=contact_hor, c_hor=c_hor, p_ref=p_ref,
                   landing=landing, landing_mask=landing_mask, stance_y=p_sy,
                   swing_is_left=swing_is_left, hdot_geom=hdot_geom)


def apply_landing_offset(plan: MPCPlan, d: torch.Tensor) -> torch.Tensor:
    """(B, 3) the planned landing with the MPC's jointly optimized offset d
    (B, 2) folded in, re-clipped for foot separation."""
    x = plan.landing[:, 0] + d[:, 0]
    y = clip_landing_y(plan.landing[:, 1] + d[:, 1], plan.stance_y, plan.swing_is_left)
    return torch.stack([x, y, plan.landing[:, 2]], dim=-1)
