"""engine/tick.py of the PyTorch port, open loop, against the JAX package on
the CPU at float64: the MPC stage of the stale cadence (``mpc_delay = 1``)
in every ``delay_comp`` mode, and one tick with every optional branch on.

* The MPC stage from a state one period into the walk with a pending
  solution, on the walk's MPC (``walking_config``: N = 20, footstep_opt,
  the factorization path): the one-step SRBD prediction, the gait-clock
  shift, the landing's fold-in.
* One tick with ``gait_gate``, ``settle_knee_guard``, ``torso_task``,
  ``hand_task`` and ``log_q`` on, at three gait phases (the DS tail, the
  swing, after the walk), with a short WBID QP: the branches are under test,
  not the solver.

Tolerance 1e-6 on every output (relative to the largest entry for the
stage's plan; absolute for the tick's torques [N m], forces [N], CoM and
q); measured maxima in CHANGES.md.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.engine import tick as jeng
from g1_locomotion_tpu.wbid.stack import StackIndices as JIdx
from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.engine import tick as teng
from g1_locomotion_tpu_torch.models.robot import load_robot

CPU = torch.device("cpu")
F64 = torch.float64
ATOL_OPEN = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pending_state(g1, cfg):
    """A state one period into the walk, with a pending solution: the
    stand's first solve applied, the gait clock and time advanced."""
    state = jeng.init_state(g1, cfg, jnp.float64)
    rng = np.random.default_rng(1)
    u0 = np.tile([0.0, 0.0, 334.7 / 4], 4) + rng.uniform(-5, 5, 12)
    x = np.array(state.x_opt0)
    x[3:6] = [0.03, 0.0, 0.6]
    x[12] = -9.80665
    return state._replace(
        t=jnp.asarray(0.52), gait_clock=jnp.asarray(0.52), u0_pend=jnp.asarray(u0),
        x_opt0_pend=jnp.asarray(x), x_opt1_pend=jnp.asarray(x + 1e-3),
        contact_pend=jnp.asarray([1.0, 1.0, 1.0, 1.0]),
        landing_pend=state.landing + jnp.asarray([0.05, 0.0, 0.0]))


@pytest.mark.parametrize("mode", ["full", "state", "clock", "none"])
def test_mpc_stage_delay_modes_match_jax(g1, mode):
    """The MPC stage of the stale cadence (mpc_delay = 1): the one-step SRBD
    prediction and the gait-clock shift, each mode's part, on the walk's
    MPC (walking_config: N = 20, footstep_opt, the factorization path)."""
    cfg = jeng.walking_config()._replace(mpc_delay=1, delay_comp=mode)
    params = jeng.walking_scenario(jnp.float64, n_steps=8.0, v_cmd=(0.1, 0.0))
    idx = JIdx.from_model(g1)
    state = _pending_state(g1, cfg)
    ref_state, ref_sol, _ = jax.jit(lambda s: jeng._mpc_stage(g1, idx, cfg, params, s))(state)
    model = load_robot("g1_23dof", device=CPU, dtype=F64)
    loop = teng.ControlLoop(model, convert.engine_config(cfg._asdict()))
    got_state, got_sol = loop._mpc_stage(convert.scenario_params(_np(params), device=CPU,
                                                                 dtype=F64),
                                         convert.engine_state(_np(state), device=CPU, dtype=F64))
    for name in ("u0", "x_opt0", "x_opt1", "contact_now", "landing", "U_warm"):
        g, r = getattr(got_state, name)[0].numpy(), np.asarray(getattr(ref_state, name))
        err = float(np.abs(g - r).max() / max(np.abs(r).max(), 1.0))
        print(f"{mode} {name}: max rel err {err:.3e}")
        assert err <= ATOL_OPEN, (name, err)
    np.testing.assert_allclose(got_sol.d[0].numpy(), np.asarray(ref_sol.d), rtol=0, atol=1e-9)


def test_tick_branches_match_jax(g1):
    """One tick with gait_gate, settle_knee_guard, torso_task, hand_task and
    log_q on, at three gait phases: the DS tail (the gate), the swing (step
    timing on), after the walk (the knee guard's fade-in); the WBID on the
    walk's factorization path."""
    cfg = jeng.walking_config()._replace(gait_gate=True, settle_knee_guard=True,
                                         torso_task=True, hand_task=True, log_q=True)
    # A short QP (the branches are under test, not the solver): the eager
    # JAX side runs every ADMM iteration op by op.
    cfg = cfg._replace(wbid=cfg.wbid._replace(qp=cfg.wbid.qp._replace(
        iters=8, rho_segments=1, polish_rounds=1)))
    params = jeng.mujoco_nominal_scenario(jnp.float64)
    params = params._replace(gait=params.gait._replace(timing_gain=jnp.asarray(3.0)))
    idx = JIdx.from_model(g1)
    base = jeng.init_state(g1, cfg, jnp.float64)
    rng = np.random.default_rng(2)
    clocks = (0.70, 0.85, 4.7)
    states = []
    for clock in clocks:
        x = np.zeros(13)
        x[3:6] = [0.02, -0.01, 0.6]
        x[12] = -9.80665
        states.append(base._replace(
            gait_clock=jnp.asarray(clock), t=jnp.asarray(clock),
            v=jnp.asarray(0.05 * rng.normal(size=g1.nv)),
            u0=jnp.asarray(np.tile([0.0, 0.0, 80.0], 4) + rng.uniform(-3, 3, 12)),
            x_opt0=jnp.asarray(x), x_opt1=jnp.asarray(x + 2e-3),
            contact_now=jnp.asarray([0.0, 0.0, 1.0, 1.0] if clock == 0.85 else [1.0] * 4),
            landing=base.landing + jnp.asarray([0.08, 0.0, 0.0])))
    batch = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *states)
    # Eager JAX: the jitted tick's WBID solution sits ~1e-2 N away under
    # XLA's reassociation (see the module's docstring); op by op it is the
    # same sequence of operations as the port's.
    ref_state, ref_log = _np(jax.jit(jax.vmap(
        lambda s: jeng._wbid_tick(g1, idx, cfg, params, s, jnp.asarray(0.5))))(batch))

    model = load_robot("g1_23dof", device=CPU, dtype=F64)
    loop = teng.ControlLoop(model, convert.engine_config(cfg._asdict()))
    got_state, got_log = loop._tick(convert.scenario_params(_np(params), device=CPU, dtype=F64),
                                    convert.engine_state(batch, device=CPU, dtype=F64),
                                    (0.5, 0.5))
    for name in ("tau", "forces", "com", "q"):
        err = float(np.abs(getattr(got_log, name).numpy() - getattr(ref_log, name)).max())
        print(f"tick {name}: max abs err {err:.3e}")
        assert err <= ATOL_OPEN, (name, err)
    for name in ("q", "v", "gait_clock", "gate_hold", "swing_xy_ref", "swing_start",
                 "contact_hold", "anchors", "prev_stance"):
        err = float(np.abs(getattr(got_state, name).numpy() - getattr(ref_state, name)).max())
        assert err <= ATOL_OPEN, (name, err)
    # The gate slowed the DS tail's clock and step timing sped the swing's.
    rate = (got_state.gait_clock - torch.tensor(clocks, dtype=F64)) / 1e-3
    print(f"gait clock rates {rate.tolist()}")
    assert rate[0] < 1.0 and rate[1] > 1.0
