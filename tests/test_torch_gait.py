"""gait/{swing,schedule,footsteps,planner}.py of the PyTorch port against the
JAX package, on the CPU at float64.

The inputs are states the JAX package's validated walk visits
(``tests/torch_walk_states.py``: ten MPC-period starts of
``walking_config`` / ``walking_scenario``, from the pre-gait stand through
the first three steps), batched over all of them; the JAX side is
``jax.vmap`` of each function. Two gait configurations: the walking
scenario's (0-d fields, shared by the batch) and one with per-instance
fields (swing and double-support durations, step-timing and lean gains
drawn with numpy from a seed), the JAX side vmapped over them too.

Tolerance: every output within 1e-12 of the JAX value, relative to the
array's largest entry (at least 1): both sides evaluate the same closed
forms in the same order, so they differ by rounding only (measured maxima
in CHANGES.md).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.engine import tick as jeng
from g1_locomotion_tpu.gait import footsteps as jfs
from g1_locomotion_tpu.gait import planner as jpl
from g1_locomotion_tpu.gait import schedule as jgs
from g1_locomotion_tpu.gait import swing as jsw
from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.gait import footsteps as tfs
from g1_locomotion_tpu_torch.gait import planner as tpl
from g1_locomotion_tpu_torch.gait import schedule as tgs
from g1_locomotion_tpu_torch.gait import swing as tsw

sys.path.insert(0, str(Path(__file__).parent))
import torch_walk_states  # noqa: E402

CPU = torch.device("cpu")
F64 = torch.float64
RTOL = 1e-12
N, DT_MPC, COM_H = 20, 0.04, 0.598


def close(got, ref, label=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    if got.dtype == bool or ref.dtype == bool:
        np.testing.assert_array_equal(got, ref, err_msg=label)
        return
    err = float(np.abs(got - ref).max() / max(float(np.abs(ref).max()), 1.0))
    print(f"{label}: max rel err {err:.2e}")
    assert err <= RTOL, (label, err)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


S = torch_walk_states.split()
B = S["x0"].shape[0]


@pytest.fixture(scope="module", params=["shared", "per_instance"])
def gait_case(request):
    """(JAX gait, JAX steps, per-instance axes for vmap, port gait, port steps)."""
    p = jeng.walking_scenario_f32_robust(jnp.float64, n_steps=8.0, v_cmd=(0.1, 0.0))
    gait, steps = p.gait, p.steps
    if request.param == "per_instance":
        rng = np.random.default_rng(0)
        gait = gait._replace(
            swing_duration=jnp.asarray(rng.uniform(0.2, 0.3, B)),
            double_support_duration=jnp.asarray(rng.uniform(0.2, 0.3, B)),
            timing_gain=jnp.asarray(rng.uniform(0.0, 4.0, B)),
            lean_gain=jnp.asarray(rng.uniform(-0.1, 0.1, B)),
            exit_blend_scale=jnp.asarray(rng.uniform(1.0, 2.0, B)),
        )
        steps = steps._replace(step_width=jnp.asarray(rng.uniform(0.1, 0.14, B)),
                               dcm_scale_x=jnp.asarray(np.where(np.arange(B) % 2, np.nan, 1.1)))
        axes = (jax.tree_util.tree_map(lambda x: 0 if jnp.ndim(x) else None, gait),
                jax.tree_util.tree_map(lambda x: 0 if jnp.ndim(x) else None, steps))
    else:
        axes = (None, None)
    tg = convert.gait_config(_np(gait), device=CPU, dtype=F64)
    ts = convert.footstep_config(_np(steps), device=CPU, dtype=F64)
    return gait, steps, axes, tg, ts


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def test_swing_matches_jax():
    """evaluate, z_coefficients and the xy phase over a grid of progress
    values, for the swing the walk has in each state (B, K)."""
    s = np.linspace(-0.1, 1.1, 13)
    p_start, p_end = S["swing_start"][:, 0], S["landing"]
    for dur in (0.25, np.linspace(0.2, 0.3, B)):
        ref = jax.vmap(lambda a, b, d: jax.vmap(
            lambda sk: jsw.evaluate(jsw.SwingParams(a, b, jnp.asarray(0.05)), sk, d))(s))(
            p_start, p_end, jnp.broadcast_to(jnp.asarray(dur), (B,)))
        sp = tsw.SwingParams(t64(p_start)[:, None], t64(p_end)[:, None], 0.05)
        got = tsw.evaluate(sp, t64(s).expand(B, -1), t64(dur).reshape(-1, 1))
        for name, g, r in zip(("pos", "vel", "acc"), got, ref):
            close(g, r, f"swing {name}")
    close(tsw.z_coefficients(tsw.SwingParams(t64(p_start), t64(p_end), t64(0.05))),
          jax.vmap(lambda a, b: jsw.z_coefficients(jsw.SwingParams(a, b, jnp.asarray(0.05))))(
              p_start, p_end), "z_coefficients")
    for fn in ("xy_phase", "xy_phase_rate", "xy_phase_accel"):
        close(getattr(tsw, fn)(t64(s)), getattr(jsw, fn)(s), fn)


def test_schedule_matches_jax(gait_case):
    """phase_info, contact flags and horizon, both LIPM orbits, the DCM
    predictors and the clock rate at the walk's states."""
    gait, steps, (gax, sax), tg, ts = gait_case
    t = S["gait_clock"]
    tt = t64(t)
    vm = lambda f: jax.vmap(f, in_axes=(gax, 0))  # noqa: E731

    ref = vm(jgs.phase_info)(gait, t)
    for name, g, r in zip(("step_idx", "in_swing", "swing_is_left", "progress"),
                          tgs.phase_info(tg, tt), ref):
        close(g, r, name)
    close(tgs.contact_flags(tg, tt), vm(jgs.contact_flags)(gait, t), "contact_flags")
    close(tgs.contact_horizon(tg, tt, N, DT_MPC),
          vm(lambda g, tk: jgs.contact_horizon(g, tk, N, DT_MPC))(gait, t), "contact_horizon")
    close(tgs.cycle_period(tg).expand(B), vm(lambda g, tk: jgs.cycle_period(g) + 0 * tk)(gait, t),
          "cycle_period")

    omega0 = np.sqrt(9.80665 / COM_H)
    W = steps.step_width
    wax = sax.step_width if sax else None
    tW = ts.step_width
    ts_ref = t[:, None] + DT_MPC * np.arange(-2, N + 8)
    v = 0.1 + 0.02 * np.arange(B)
    y, vy = jax.vmap(lambda g, w, tk: jgs.lateral_orbit_reference(g, tk, omega0, w),
                     in_axes=(gax, wax, 0))(gait, W, ts_ref)
    ty, tvy = tgs.lateral_orbit_reference(tg, t64(ts_ref), t64(omega0), tW)
    close(ty, y, "lateral y")
    close(tvy, vy, "lateral vy")
    x, vx = jax.vmap(lambda g, vk, tk: jgs.sagittal_orbit_reference(g, tk, omega0, vk),
                     in_axes=(gax, 0, 0))(gait, v, ts_ref)
    tx, tvx = tgs.sagittal_orbit_reference(tg, t64(ts_ref), t64(omega0), t64(v))
    close(tx, x, "sagittal x")
    close(tvx, vx, "sagittal vx")

    # The DCM predictors at each state's phase, for both swing sides, with
    # a DCM taken from the state (and moved off the orbit).
    half = np.asarray(gait.swing_duration + gait.double_support_duration)
    t_in = np.mod(t - np.asarray(gait.start_time), np.broadcast_to(half, (B,)))
    xi = S["x0"][:, 4] + S["x0"][:, 10] / omega0 + 0.03 * np.sin(np.arange(B))
    left = np.arange(B) % 2 == 0
    args = (gait, W, xi, t_in, left)
    in_axes = (gax, wax, 0, 0, 0)
    targs = (tg, tW, t64(xi), t64(t_in), torch.tensor(left))
    for fn in ("predict_touchdown_dcm", "predict_ds_end_dcm", "timing_clock_rate"):
        r = jax.vmap(lambda g, w, a, b, c, f=getattr(jgs, fn): f(g, omega0, w, a, b, c),
                     in_axes=in_axes)(*args)
        close(getattr(tgs, fn)(targs[0], t64(omega0), *targs[1:]), r, fn)
    for fn in ("touchdown_dcm_nominal", "swing_onset_dcm_nominal"):
        r = jax.vmap(lambda g, w, c, f=getattr(jgs, fn): f(g, omega0, w, c),
                     in_axes=(gax, wax, 0))(gait, W, left)
        close(getattr(tgs, fn)(tg, t64(omega0), tW, torch.tensor(left)), r, fn)
    close(tgs.touchdown_dcm_nominal_x(tg, t64(omega0), t64(v)),
          jax.vmap(lambda g, vk: jgs.touchdown_dcm_nominal_x(g, omega0, vk),
                   in_axes=(gax, 0))(gait, v), "touchdown_dcm_nominal_x")
    close(tgs.predict_touchdown_dcm_x(tg, t64(omega0), t64(v), t64(xi), t64(t_in)),
          jax.vmap(lambda g, vk, a, b: jgs.predict_touchdown_dcm_x(g, omega0, vk, a, b),
                   in_axes=(gax, 0, 0, 0))(gait, v, xi, t_in), "predict_touchdown_dcm_x")


def test_footsteps_match_jax(gait_case):
    _, steps, (_, sax), _, ts = gait_case
    left = np.arange(B) % 2 == 0
    step_idx = np.arange(B, dtype=np.float64)
    x0 = S["x0"]
    v_cmd = np.stack([0.1 + 0.01 * np.arange(B), -0.02 * np.ones(B)], axis=1)
    stance = np.full(B, 0.25)
    close(tfs.dcm_scale_sagittal(ts).expand(B),
          jax.vmap(lambda s, k: jfs.dcm_scale_sagittal(s) + 0 * k, in_axes=(sax, 0))(steps, stance),
          "dcm_scale_sagittal")
    close(tfs.fixed_plan(ts, t64(step_idx), torch.tensor(left), t64(S["cpos"][:, 0, :2])),
          jax.vmap(jfs.fixed_plan, in_axes=(sax, 0, 0, 0))(steps, step_idx, left,
                                                             S["cpos"][:, 0, :2]), "fixed_plan")
    close(tfs.raibert(ts, t64(x0[:, 3:6]), t64(x0[:, 9:12]), t64(v_cmd), torch.tensor(left),
                      t64(stance)),
          jax.vmap(jfs.raibert, in_axes=(sax, 0, 0, 0, 0, 0))(
              steps, x0[:, 3:6], x0[:, 9:12], v_cmd, left, stance), "raibert")


@pytest.mark.parametrize("plan_extras", [False, True])
def test_plan_horizon_matches_jax(gait_case, plan_extras):
    """plan_horizon at the walk's states (N = 20, walking_config's horizon),
    with a gate hold on one row and the landing lock on another; with
    plan_extras the pre-stop, stop ramp and scheduled DCM gain are on.
    Then apply_landing_offset with an offset per row."""
    gait, steps, (gax, sax), tg, ts = gait_case
    if plan_extras:
        gait = gait._replace(stop_ramp_s=jnp.asarray(0.3), pre_stop_s=jnp.asarray(0.4))
        steps = steps._replace(dcm_err_gain=jnp.asarray(2.0), dcm_corr_max=jnp.asarray(0.05))
        tg = tg._replace(stop_ramp_s=t64(0.3), pre_stop_s=t64(0.4))
        ts = ts._replace(dcm_err_gain=t64(2.0), dcm_corr_max=t64(0.05))
        gax = gax._replace(stop_ramp_s=None, pre_stop_s=None) if gax else None
        sax = sax._replace(dcm_err_gain=None, dcm_corr_max=None) if sax else None
    hold = S["hold"].copy()
    hold[1] = 1.0
    lock = np.zeros(B)
    lock[4] = 1.0
    # A later clock on the last rows reaches the settle and the stop ramp.
    clock = S["gait_clock"] + np.where(np.arange(B) >= B - 2, 3.0, 0.0)
    v_cmd = np.stack([0.1 + 0.01 * np.arange(B), 0.02 * np.cos(np.arange(B))], axis=1)

    def plan(g, s, v, x0, cpos, c, h, prev, lk, ss):
        return jpl.plan_horizon(g, s, v, x0, cpos, c, N, DT_MPC, COM_H, hold=h,
                                prev_landing=prev, lock_flag=lk, swing_start=ss, z_apex=0.05,
                                plan_extras=plan_extras)

    ref = jax.vmap(plan, in_axes=(gax, sax) + (0,) * 8)(
        gait, steps, v_cmd, S["x0"], S["cpos"], clock, hold, S["landing"], lock,
        S["swing_start"])
    got = tpl.plan_horizon(tg, ts, t64(v_cmd), t64(S["x0"]), t64(S["cpos"]), t64(clock), N,
                           DT_MPC, COM_H, hold=t64(hold), prev_landing=t64(S["landing"]),
                           lock_flag=t64(lock), swing_start=t64(S["swing_start"]), z_apex=0.05,
                           plan_extras=plan_extras)
    for name in jpl.MPCPlan._fields:
        close(getattr(got, name), getattr(ref, name), f"plan {name}")

    d = 0.01 * np.stack([np.sin(np.arange(B)), np.cos(3 * np.arange(B))], axis=1)
    close(tpl.apply_landing_offset(got, t64(d)),
          jax.vmap(jpl.apply_landing_offset)(ref, d), "apply_landing_offset")
    close(tpl.clip_landing_y(t64(S["landing"][:, 1] + d[:, 1]), got.stance_y, got.swing_is_left),
          jax.vmap(jpl.clip_landing_y)(S["landing"][:, 1] + d[:, 1], ref.stance_y,
                                       ref.swing_is_left), "clip_landing_y")
