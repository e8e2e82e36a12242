"""Phase-based gait schedule: contact flags, the periodic LIPM orbits the
planner references, DCM predictors and the step-timing clock rate.

Port of ``g1_locomotion_tpu/gait/schedule.py``, batched. Every
:class:`GaitConfig` field is a tensor that broadcasts against the batch:
0-d (shared by every instance) or ``(B,)`` (randomized per instance). Times
are ``(B,)`` (or 0-d); the horizon functions take ``(B, K)`` times and lift
the configuration's fields to ``(B, 1)`` themselves.

Cycle structure (walking): each step is [DS][swing]; even steps swing the
left foot. Contact order: [L-heel, L-toe, R-heel, R-toe].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from benchmark.reference.g1ref._device import const


class GaitConfig(NamedTuple):
    """Gait timing and weight-transfer parameters; the reference's fields
    (its module documents each one)."""

    swing_duration: torch.Tensor           # s
    double_support_duration: torch.Tensor  # s between swings
    start_time: torch.Tensor               # gait starts after a stand phase
    n_steps: torch.Tensor                  # steps before standing again
    sway_gain: torch.Tensor                # lateral orbit amplitude in the CoM reference
    gate_window: torch.Tensor              # DS tail of the weight-transfer gate (0 = off)
    gate_xi_tol: torch.Tensor              # gate tolerance on the lateral DCM [m]
    gate_z_tol: torch.Tensor               # crouch guard: com_z > target - tol [m]
    gate_vz_tol: torch.Tensor              # ... and vz > -tol [m/s]
    swing_xy_rate_max: torch.Tensor        # cap on the swing xy reference speed [m/s]
    timing_gain: torch.Tensor              # step-timing clock speed-up per m (0 = off)
    timing_tol: torch.Tensor               # touchdown-DCM deadband [m]
    timing_rate_max: torch.Tensor          # cap on the sped-up clock rate
    ds_slow_gain: torch.Tensor             # DS slow-down per m of DCM shortfall (0 = off)
    ds_rate_min: torch.Tensor              # floor of the slowed clock rate
    landing_lock: torch.Tensor             # swing fraction that freezes the landing
    lean_gain: torch.Tensor                # stance-side torso lean [rad] (0 = off)
    settle_blend_s: torch.Tensor           # settle-anchor blend [s]
    exit_blend_scale: torch.Tensor         # exit blend of the lateral orbit [DS windows]
    stop_ramp_s: torch.Tensor              # sagittal stop ramp [s] (plan_extras)
    pre_stop_s: torch.Tensor               # pre-stop deceleration [s] (plan_extras)


_DEFAULTS = dict(
    swing_duration=0.25, double_support_duration=0.25, start_time=0.5, n_steps=8.0,
    sway_gain=1.0, gate_window=0.0, gate_xi_tol=0.03, gate_z_tol=0.06, gate_vz_tol=0.40,
    swing_xy_rate_max=1.8, timing_gain=0.0, timing_tol=0.05, timing_rate_max=2.0,
    ds_slow_gain=0.0, ds_rate_min=0.4, landing_lock=1.0, lean_gain=0.0, settle_blend_s=1.0,
    exit_blend_scale=1.0, stop_ramp_s=0.0, pre_stop_s=0.0,
)


def default_gait(*, device, dtype=torch.float32) -> GaitConfig:
    """The reference's defaults, 0-d tensors (shared by the batch)."""
    return GaitConfig(**{k: torch.tensor(v, dtype=dtype, device=device)
                         for k, v in _DEFAULTS.items()})


def lift(cfg: GaitConfig) -> GaitConfig:
    """Every field with a trailing unit axis, against (B, K) times."""
    return GaitConfig(*(f[..., None] for f in cfg))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` = min(max(x, lo), hi) for numbers, tensors or
    None (an open side)."""
    for bound, op in ((lo, torch.maximum), (hi, torch.minimum)):
        if bound is None:
            continue
        if isinstance(bound, torch.Tensor):
            x = op(x, bound)
        else:
            x = torch.clamp(x, min=bound) if op is torch.maximum else torch.clamp(x, max=bound)
    return x


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (M @ x[..., None])[..., 0]


def cycle_period(cfg: GaitConfig) -> torch.Tensor:
    return 2.0 * (cfg.swing_duration + cfg.double_support_duration)


def phase_info(cfg: GaitConfig, t: torch.Tensor):
    """(step_index, in_swing, swing_is_left, swing_progress) at time t: even
    steps swing the left foot; before start_time and after n_steps both
    feet stand."""
    half = cfg.swing_duration + cfg.double_support_duration
    tau = t - cfg.start_time
    step_idx = torch.floor(tau / half)
    in_gait = (tau >= 0.0) & (step_idx < cfg.n_steps)
    t_in_step = tau - step_idx * half
    in_swing = in_gait & (t_in_step >= cfg.double_support_duration)
    progress = clip((t_in_step - cfg.double_support_duration) / cfg.swing_duration, 0.0, 1.0)
    swing_is_left = torch.remainder(step_idx, 2.0) < 0.5
    return step_idx, in_swing, swing_is_left, progress


def contact_flags(cfg: GaitConfig, t: torch.Tensor) -> torch.Tensor:
    """(..., 4) flags [L-heel, L-toe, R-heel, R-toe] at times t."""
    _, in_swing, swing_is_left, _ = phase_info(cfg, t)
    left = torch.where(in_swing & swing_is_left, 0.0, 1.0)
    right = torch.where(in_swing & ~swing_is_left, 0.0, 1.0)
    return torch.stack([left, left, right, right], dim=-1).to(t.dtype)


def _lipm_map(omega0, T, p0, pdot):
    """Affine map (F (..., 2, 2), g (..., 2)) of the lateral LIPM state
    [y, vy] over a duration T while the ZMP ramps from p0 with slope pdot:
    X(T) = F X(0) + g."""
    omega0, T, p0, pdot = torch.broadcast_tensors(omega0, T, p0, pdot)
    c = torch.cosh(omega0 * T)
    s = torch.sinh(omega0 * T)
    F = torch.stack([torch.stack([c, s / omega0], dim=-1),
                     torch.stack([omega0 * s, c], dim=-1)], dim=-2)
    p1 = p0 + pdot * T
    g = torch.stack([p1 - c * p0 - (s / omega0) * pdot,
                     pdot - omega0 * s * p0 - c * pdot], dim=-1)
    return F, g


def _solve2(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(A, b[..., None]).result[..., 0]  # no error-check sync


def lateral_orbit_state(cfg: GaitConfig, omega0, W) -> torch.Tensor:
    """(..., 2) initial state [y, vy] (at DS start of an even, right-stance
    step) of the periodic lateral LIPM orbit: X0 = -(I + F)^-1 g."""
    ds = cfg.double_support_duration
    ss = cfg.swing_duration
    F1, g1 = _lipm_map(omega0, ds, W, -2.0 * W / torch.clamp(ds, min=1e-6))
    F2, g2 = _lipm_map(omega0, ss, -W, torch.zeros_like(W))
    F = F2 @ F1
    g = _mv(F2, g1) + g2
    return -_solve2(const(((1.0, 0.0), (0.0, 1.0)), g) + F, g)


def _orbit_eval(cfg: GaitConfig, omega0, W, X0, t_in):
    """The even-step orbit at phase time t_in in [0, ds + ss)."""
    ds = cfg.double_support_duration
    pdot = -2.0 * W / torch.clamp(ds, min=1e-6)
    t1 = clip(t_in, 0.0, ds)
    F1, g1 = _lipm_map(omega0, t1, W, pdot)
    X_ds = _mv(F1, X0) + g1
    t2 = clip(t_in - ds, 0.0, None)
    Fds, gds = _lipm_map(omega0, ds, W, pdot)
    F2, g2 = _lipm_map(omega0, t2, -W, torch.zeros_like(W))
    X_ss = _mv(F2, _mv(Fds, X0) + gds) + g2
    return torch.where((t_in < ds)[..., None], X_ds, X_ss)


def _blend_in(tau, ds):
    s_in = clip(tau / torch.clamp(ds, min=1e-6), 0.0, 1.0)
    return 0.5 * (1.0 - torch.cos(math.pi * s_in))


def lateral_orbit_reference(cfg: GaitConfig, t: torch.Tensor, omega0, W
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, vy), each (B, K), of the periodic lateral orbit at times t (B, K),
    centerline-relative; omega0 and W broadcast against (B,). Odd steps
    mirror the even-step orbit; the first DS blends in from standing and the
    gait end blends out over exit_blend_scale DS windows."""
    omega0, W = torch.as_tensor(omega0, dtype=t.dtype, device=t.device), torch.as_tensor(W)
    X0 = lateral_orbit_state(cfg, omega0, W)[..., None, :]
    c, om, w = lift(cfg), omega0[..., None], W[..., None]
    half = c.swing_duration + c.double_support_duration
    ds = c.double_support_duration
    tau = t - c.start_time
    j = torch.floor(tau / half)
    t_in = tau - j * half
    X = _orbit_eval(c, om, w, X0, t_in)
    even = torch.remainder(clip(j, 0.0, None), 2.0) < 0.5
    X = torch.where(even[..., None], X, -X)
    X = X * _blend_in(tau, ds)[..., None]
    t_end = c.n_steps * half
    s_out = clip((tau - t_end) / torch.clamp(ds * c.exit_blend_scale, min=1e-6), 0.0, 1.0)
    X_end_hold = _orbit_eval(c, om, w, X0, torch.zeros_like(t_in))
    last_even = torch.remainder(torch.clamp(c.n_steps, min=0.0), 2.0) < 0.5
    X_end_hold = torch.where(last_even[..., None], X_end_hold, -X_end_hold)
    X_out = X_end_hold * (1.0 - 0.5 * (1.0 - torch.cos(math.pi * s_out)))[..., None]
    X = torch.where((tau >= t_end)[..., None], X_out, X)
    X = torch.where(((tau < 0.0) | (c.n_steps < 0.5))[..., None], torch.zeros_like(X), X)
    return X[..., 0], X[..., 1]


def touchdown_dcm_nominal(cfg: GaitConfig, omega0, W, swing_is_left):
    """Nominal centerline-relative DCM y + vy / omega0 at touchdown of the
    current step (a left landing ends the even-step orbit at -X0)."""
    X0 = lateral_orbit_state(cfg, omega0, W)
    xi0 = X0[..., 0] + X0[..., 1] / omega0
    return torch.where(swing_is_left, -xi0, xi0)


def swing_onset_dcm_nominal(cfg: GaitConfig, omega0, W, swing_is_left):
    """Nominal centerline-relative DCM at swing onset (end of this step's
    double support): the weight-transfer gate's target."""
    X0 = lateral_orbit_state(cfg, omega0, W)
    X = _orbit_eval(cfg, omega0, W, X0, cfg.double_support_duration)
    xi = X[..., 0] + X[..., 1] / omega0
    return torch.where(swing_is_left, xi, -xi)


def predict_ds_end_dcm(cfg: GaitConfig, omega0, W, xi, t_in, swing_is_left):
    """The measured DCM propagated through the rest of this step's DS ZMP
    ramp to swing onset."""
    ds = cfg.double_support_duration
    xi_e = torch.where(swing_is_left, xi, -xi)
    t_rem = clip(ds - t_in, 0.0, None)
    pdot = -2.0 * W / torch.clamp(ds, min=1e-6)
    p_now = W + pdot * clip(t_in, 0.0, ds)
    off = pdot / omega0
    p1 = -W
    xi_e = (p1 + off) + (xi_e - p_now - off) * torch.exp(omega0 * t_rem)
    return torch.where(swing_is_left, xi_e, -xi_e)


def predict_touchdown_dcm(cfg: GaitConfig, omega0, W, xi, t_in, swing_is_left):
    """The measured DCM propagated to the upcoming touchdown through the
    step's nominal ZMP profile (rest of the DS ramp, then the SS hold)."""
    ds = cfg.double_support_duration
    ss = cfg.swing_duration
    xi_e = torch.where(swing_is_left, xi, -xi)
    t_ds_rem = clip(ds - t_in, 0.0, None)
    pdot = -2.0 * W / torch.clamp(ds, min=1e-6)
    p_now = W + pdot * clip(t_in, 0.0, ds)
    off = pdot / omega0
    p1 = -W
    xi_e = torch.where(t_in < ds,
                       (p1 + off) + (xi_e - p_now - off) * torch.exp(omega0 * t_ds_rem), xi_e)
    t_ss_rem = torch.where(t_in < ds, ss, clip(ds + ss - t_in, 0.0, None))
    xi_e = -W + (xi_e + W) * torch.exp(omega0 * t_ss_rem)
    return torch.where(swing_is_left, xi_e, -xi_e)


def _sagittal_zmp(omega0, v, T, c0, ds):
    """Per-phase (p0, pdot) of the ramp-relative sagittal ZMP profile."""
    p0_ds = c0 - v * T
    pdot_ds = -v + v * T / torch.clamp(ds, min=1e-6)
    p0_ss = c0 - v * ds
    pdot_ss = -v + 0.0 * c0
    return (p0_ds, pdot_ds), (p0_ss, pdot_ss)


def sagittal_orbit_state(cfg: GaitConfig, omega0, v) -> torch.Tensor:
    """(..., 2) ramp-relative initial state [x_rel, vx_rel] (at DS start) of
    the shift-periodic sagittal orbit at forward speed v: X0 = (I - F)^-1 g."""
    ds = cfg.double_support_duration
    ss = cfg.swing_duration
    T = ds + ss
    c0 = 0.5 * v * T
    (p0_ds, pdot_ds), (p0_ss, pdot_ss) = _sagittal_zmp(omega0, v, T, c0, ds)
    F1, g1 = _lipm_map(omega0, ds, p0_ds, pdot_ds)
    F2, g2 = _lipm_map(omega0, ss, p0_ss, pdot_ss)
    F = F2 @ F1
    g = _mv(F2, g1) + g2
    return _solve2(const(((1.0, 0.0), (0.0, 1.0)), g) - F, g)


def _sagittal_orbit_eval(cfg: GaitConfig, omega0, v, X0, t_in):
    ds = cfg.double_support_duration
    ss = cfg.swing_duration
    T = ds + ss
    c0 = 0.5 * v * T
    (p0_ds, pdot_ds), (p0_ss, pdot_ss) = _sagittal_zmp(omega0, v, T, c0, ds)
    t1 = clip(t_in, 0.0, ds)
    F1, g1 = _lipm_map(omega0, t1, p0_ds, pdot_ds)
    X_ds = _mv(F1, X0) + g1
    Fds, gds = _lipm_map(omega0, ds, p0_ds, pdot_ds)
    t2 = clip(t_in - ds, 0.0, None)
    F2, g2 = _lipm_map(omega0, t2, p0_ss, pdot_ss)
    X_ss = _mv(F2, _mv(Fds, X0) + gds) + g2
    return torch.where((t_in < ds)[..., None], X_ds, X_ss)


def sagittal_orbit_reference(cfg: GaitConfig, t: torch.Tensor, omega0, v
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_rel, vx_rel), each (B, K), of the shift-periodic sagittal orbit at
    times t (B, K), relative to the commanded ramp; every step identical,
    entry and exit blends over one DS window."""
    omega0 = torch.as_tensor(omega0, dtype=t.dtype, device=t.device)
    X0 = sagittal_orbit_state(cfg, omega0, v)[..., None, :]
    c, om, vv = lift(cfg), omega0[..., None], v[..., None]
    half = c.swing_duration + c.double_support_duration
    ds = c.double_support_duration
    tau = t - c.start_time
    j = torch.floor(tau / half)
    t_in = tau - j * half
    X = _sagittal_orbit_eval(c, om, vv, X0, t_in)
    X = X * _blend_in(tau, ds)[..., None]
    t_end = c.n_steps * half
    s_out = clip((tau - t_end) / torch.clamp(ds, min=1e-6), 0.0, 1.0)
    X_out = X0 * (1.0 - 0.5 * (1.0 - torch.cos(math.pi * s_out)))[..., None]
    X = torch.where((tau >= t_end)[..., None], X_out, X)
    X = torch.where(((tau < 0.0) | (c.n_steps < 0.5))[..., None], torch.zeros_like(X), X)
    return X[..., 0], X[..., 1]


def touchdown_dcm_nominal_x(cfg: GaitConfig, omega0, v):
    """Nominal ramp-relative sagittal DCM at touchdown (X0's DCM)."""
    X0 = sagittal_orbit_state(cfg, omega0, v)
    return X0[..., 0] + X0[..., 1] / omega0


def predict_touchdown_dcm_x(cfg: GaitConfig, omega0, v, xi, t_in):
    """The measured sagittal DCM propagated to the upcoming touchdown
    through the step's nominal ramp-relative ZMP profile."""
    ds = cfg.double_support_duration
    ss = cfg.swing_duration
    T = ds + ss
    c0 = 0.5 * v * T
    (p0_ds, pdot_ds), (p0_ss, pdot_ss) = _sagittal_zmp(omega0, v, T, c0, ds)
    t_ds_rem = clip(ds - t_in, 0.0, None)
    p_now = p0_ds + pdot_ds * clip(t_in, 0.0, ds)
    off = pdot_ds / omega0
    p1 = p0_ds + pdot_ds * ds
    xi = torch.where(t_in < ds,
                     (p1 + off) + (xi - p_now - off) * torch.exp(omega0 * t_ds_rem), xi)
    t_ss_rem = torch.where(t_in < ds, ss, clip(ds + ss - t_in, 0.0, None))
    p_now_ss = p0_ss + pdot_ss * clip(torch.maximum(t_in, ds) - ds, 0.0, ss)
    off_ss = pdot_ss / omega0
    p1_ss = p0_ss + pdot_ss * ss
    return (p1_ss + off_ss) + (xi - p_now_ss - off_ss) * torch.exp(omega0 * t_ss_rem)


def timing_clock_rate(cfg: GaitConfig, omega0, W, xi_rel, t_in_step, swing_is_left):
    """Step-timing adaptation: the gait clock's rate during the swing, 1
    until the predicted touchdown DCM leaves the orbit's by timing_tol, then
    faster in proportion (at most timing_rate_max); timing_gain = 0 gives 1."""
    xi_pred = predict_touchdown_dcm(cfg, omega0, W, xi_rel, t_in_step, swing_is_left)
    xi_nom = touchdown_dcm_nominal(cfg, omega0, W, swing_is_left)
    err = torch.abs(xi_pred - xi_nom)
    return clip(1.0 + cfg.timing_gain * torch.clamp(err - cfg.timing_tol, min=0.0),
                1.0, torch.clamp(cfg.timing_rate_max, min=1.0))


def contact_horizon(cfg: GaitConfig, t: torch.Tensor, horizon: int, dt_mpc: float
                    ) -> torch.Tensor:
    """(B, N, 4) contact flags over the MPC horizon starting at t (B,)."""
    ts = t[..., None] + dt_mpc * torch.arange(horizon, dtype=t.dtype, device=t.device)
    return contact_flags(lift(cfg), ts)
