"""mpc/srbd_loop.py of the PyTorch port (the SRBD-level closed loop of
planner, MPC and rigid body) against the JAX package's, on the CPU at
float64.

* ``init_loop_state`` and ``contacts_from_feet``: equal.
* The validated SRBD walk (``walking_config().mpc``: horizon 20, footstep
  optimization, the factorization path; ``walking_scenario`` at 0.1 m/s):
  the first period is open loop from the same state, held to 1e-10
  relative; a prefix of ``PREFIX`` periods (1.2 s: the stand, the first
  double support, the first swing and its touchdown) with the contact flags
  equal and every logged field within 1e-10 relative too; a batch of three
  instances with three different lateral kicks at period ``KICK_AT``
  against three JAX runs. One jitted JAX rollout serves these cases.
* The loop's model-mismatch and substep options, 4 periods, 1e-10.
* ``slow``: the three walks of ``tests/test_srbd_loop.py`` on the port.

Measured: 3e-14 relative for the first period, 1.7e-13 over the prefixes
(the forces u0 and pri_res; every state field below 4e-14).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.engine import tick as jeng
from g1_locomotion_tpu.mpc import srbd_loop as jsl
from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.engine import tick as teng
from g1_locomotion_tpu_torch.mpc import srbd_loop as tsl

CPU = torch.device("cpu")
F64 = torch.float64
PREFIX = 30
KICK_AT = 10
KICKS_Y = (0.0, 0.06, -0.12)  # lateral kick of each batch instance [m/s]
OPEN_RTOL = 1e-10
PREFIX_TOL = 1e-10  # relative to each field's scale (at least 1)


def _cfg():
    return jeng.walking_config().mpc


def _kicks(n_periods, kicks_y):
    k = np.zeros((len(kicks_y), n_periods, 3))
    k[:, KICK_AT, 1] = kicks_y
    return k


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's PREFIX-period rollouts, one per kick of KICKS_Y."""
    cfg = _cfg()
    params = jeng.walking_scenario(jnp.float64, n_steps=8.0, v_cmd=(0.1, 0.0))
    rollout = jsl.make_srbd_loop(cfg)
    state0 = jsl.init_loop_state(cfg, 0.598, jnp.float64)
    run = jax.jit(lambda s, p, k: rollout(s, p, PREFIX, k))
    out = []
    for k in _kicks(PREFIX, KICKS_Y):
        fin, log = run(state0, params, jnp.asarray(k))
        out.append((jax.tree_util.tree_map(np.asarray, fin),
                    jax.tree_util.tree_map(np.asarray, log)))
    return params, out


def _port(params, batch):
    cfg = convert.mpc_config(_cfg()._asdict())
    loop = tsl.SRBDLoop(cfg)
    state = tsl.init_loop_state(cfg, 0.598, batch=batch, device=CPU, dtype=F64)
    return loop, state, convert.scenario_params(jax.tree_util.tree_map(np.asarray, params),
                                                device=CPU, dtype=F64)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0))


def test_init_state_and_contacts_match_jax():
    cfg = _cfg()
    ref = jsl.init_loop_state(cfg, 0.598, jnp.float64)
    got = tsl.init_loop_state(convert.mpc_config(cfg._asdict()), 0.598, batch=2, device=CPU,
                              dtype=F64)
    for name in tsl.SRBDLoopState._fields:
        g, r = getattr(got, name), np.asarray(getattr(ref, name))
        assert g.shape == (2,) + r.shape, name
        np.testing.assert_array_equal(g[1].numpy(), r, err_msg=name)
    carried = convert.srbd_loop_state(jax.tree_util.tree_map(np.asarray, ref), device=CPU,
                                      dtype=F64)
    for a, b in zip(carried, got):
        assert torch.equal(a, b[:1])
    feet = np.random.default_rng(0).uniform(-0.3, 0.3, (3, 2, 3))
    got = tsl.contacts_from_feet(torch.tensor(feet, dtype=F64))
    for b in range(3):
        np.testing.assert_array_equal(got[b].numpy(),
                                      np.asarray(jsl.contacts_from_feet(jnp.asarray(feet[b]))))
    assert tsl.SRBDLoopState._fields == jsl.SRBDLoopState._fields
    assert tsl.SRBDLoopLog._fields == jsl.SRBDLoopLog._fields


def test_one_period_matches_jax(jax_runs):
    params, runs = jax_runs
    loop, state, tparams = _port(params, 1)
    fin, log = loop.period(state, tparams)
    _, ref = runs[0]
    for name in tsl.SRBDLoopLog._fields:
        err = _rel(getattr(log, name)[0].numpy(), getattr(ref, name)[0])
        print(f"{name}: max rel err {err:.3e} (<= {OPEN_RTOL})")
        assert err <= OPEN_RTOL, (name, err)
    # The carried state is the logged one, and the warm start the MPC's plan.
    assert torch.equal(fin.x, log.x) and torch.equal(fin.feet, log.feet)
    assert torch.equal(fin.U_warm[:, 0], log.u0) and torch.equal(fin.prev_stance, log.contact)


def _check_prefix(log, ref, b):
    np.testing.assert_array_equal(log.contact[b].numpy(), ref.contact)
    for name in tsl.SRBDLoopLog._fields:
        err = _rel(getattr(log, name)[b].numpy(), getattr(ref, name))
        print(f"instance {b} {name}: max rel err {err:.3e} over {PREFIX} periods "
              f"(<= {PREFIX_TOL})")
        assert err <= PREFIX_TOL, (b, name, err)


def test_prefix_through_first_touchdown_matches_jax(jax_runs):
    params, runs = jax_runs
    loop, state, tparams = _port(params, 1)
    _, log = loop.rollout(state, tparams, PREFIX)
    ref = runs[0][1]
    # The prefix holds the first left swing and its touchdown.
    left = ref.contact[:, 0]
    assert left.min() == 0.0 and left[-1] == 1.0
    _check_prefix(log, ref, 0)


def test_kicked_batch_matches_jax(jax_runs):
    """Three instances, three kicks, one batch: each against its JAX run."""
    params, runs = jax_runs
    loop, state, tparams = _port(params, len(KICKS_Y))
    kicks = torch.tensor(_kicks(PREFIX, KICKS_Y), dtype=F64)
    _, log = loop.rollout(state, tparams, PREFIX, kicks)
    assert log.x.shape == (len(KICKS_Y), PREFIX, 13)
    for b, (_, ref) in enumerate(runs):
        _check_prefix(log, ref, b)
    # The kicks took: the instances' lateral velocities differ after KICK_AT.
    vy = log.x[:, KICK_AT, 10]
    assert float((vy[1] - vy[0]).abs()) > 0.05 and float((vy[2] - vy[0]).abs()) > 0.1


def test_model_mismatch_and_substeps_match_jax():
    """The loop's two study options: a simulated body other than the MPC's
    (mass x 1.1, inertia x 0.9) integrated in 3 substeps a period, 4
    periods of a horizon-8 MPC, against the JAX package's make_srbd_loop
    with the same options."""
    from g1_locomotion_tpu.models import srbd as jsrbd
    from g1_locomotion_tpu_torch.models import srbd as tsrbd

    cfg = jeng.walking_config().mpc._replace(horizon=8)
    params = jeng.walking_scenario(jnp.float64, n_steps=8.0, v_cmd=(0.1, 0.0))
    mass, inertia = np.asarray(params.srbd.mass) * 1.1, np.asarray(params.srbd.inertia) * 0.9
    rollout = jsl.make_srbd_loop(cfg, 0.598, 3, jsrbd.SRBDParams(mass=jnp.asarray(mass),
                                                                  inertia=jnp.asarray(inertia)))
    state0 = jsl.init_loop_state(cfg, 0.598, jnp.float64)
    _, ref = jax.jit(lambda s, p: rollout(s, p, 4))(state0, params)
    tcfg = convert.mpc_config(cfg._asdict())
    sim = tsrbd.SRBDParams(mass=torch.tensor(mass), inertia=torch.tensor(inertia))
    _, log = tsl.make_srbd_loop(tcfg, 0.598, 3, sim)(
        tsl.init_loop_state(tcfg, 0.598, device=CPU, dtype=F64),
        convert.scenario_params(jax.tree_util.tree_map(np.asarray, params), device=CPU,
                                dtype=F64), 4)
    for name in ("x", "u0", "plan_x1"):
        err = _rel(getattr(log, name)[0].numpy(), np.asarray(getattr(ref, name)))
        print(f"{name}: max rel err {err:.3e} over 4 periods (<= {PREFIX_TOL})")
        assert err <= PREFIX_TOL, (name, err)
    # The mismatch shows: the realized state leaves the MPC's prediction.
    assert float((log.x - log.plan_x1).abs().max()) > 1e-4


def _walk(n_steps, v_cmd, n_periods, kicks=None, dcm_scale=1.0):
    """tests/test_srbd_loop.py's _walk on the port."""
    cfg = teng.walking_config().mpc
    params = teng.walking_scenario(device=CPU, dtype=F64, n_steps=n_steps, v_cmd=v_cmd)
    params = params._replace(steps=params.steps._replace(
        dcm_scale=torch.tensor(dcm_scale, dtype=F64)))
    state0 = tsl.init_loop_state(cfg, 0.598, device=CPU, dtype=F64)
    final, logs = tsl.make_srbd_loop(cfg)(state0, params, n_periods, kicks)
    return params, final, logs


@pytest.mark.slow
def test_srbd_walk_8_steps_and_settle():
    _, _, logs = _walk(8.0, (0.1, 0.0), 200)
    x = logs.x[0].numpy()
    assert np.isfinite(x).all()
    np.testing.assert_allclose(x[:, 5], 0.598, atol=0.055)
    np.testing.assert_allclose(x[-20:, 5], 0.598, atol=2e-3)
    assert np.abs(x[:, 4]).max() < 0.25, np.abs(x[:, 4]).max()
    assert 0.25 < x[-1, 3] < 0.65, x[-1, 3]
    assert np.abs(x[-1, 9:11]).max() < 0.05
    c = logs.contact[0].numpy()
    td = np.clip(np.diff((c > 0.5).astype(int), axis=0), 0, 1).sum(axis=0)
    assert td[0] >= 4 and td[1] >= 4, td


@pytest.mark.slow
def test_srbd_walk_velocity_tracking():
    for v in (0.1, 0.2):
        _, _, logs = _walk(8.0, (v, 0.0), 200)
        x = logs.x[0].numpy()
        t0, t1 = int(1.5 / 0.04), int(4.0 / 0.04)
        v_real = (x[t1, 3] - x[t0, 3]) / ((t1 - t0) * 0.04)
        assert abs(v_real - v) < 0.3 * v + 0.02, (v, v_real)


@pytest.mark.slow
def test_srbd_walk_kick_recovery():
    kicks = torch.zeros((1, 200, 3), dtype=F64)
    kicks[0, 60, 1] = 0.15
    _, _, logs = _walk(8.0, (0.1, 0.0), 200, kicks=kicks)
    x = logs.x[0].numpy()
    assert np.isfinite(x).all()
    np.testing.assert_allclose(x[:, 5], 0.598, atol=0.055)
    assert np.abs(x[-1, 9:11]).max() < 0.05
    assert np.abs(x[-1, 4]) < 0.3


def test_init_loop_state_needs_a_device_without_cuda(monkeypatch):
    """Without a device the loop's state goes to the card (and raises without
    one); the CPU is the caller's explicit choice."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = teng.walking_config().mpc
    with pytest.raises(RuntimeError, match="CUDA"):
        tsl.init_loop_state(cfg, 0.598)
    assert tsl.init_loop_state(cfg, 0.598, device=CPU).x.device == CPU
