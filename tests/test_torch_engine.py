"""engine/tick.py of the PyTorch port (ControlLoop, the configs and
scenarios) against the JAX package's ``make_rollout``, on the CPU at
float64.

* One control period (an MPC solve, 40 WBID ticks, 40 plant steps) of the
  serving configuration (``tools/bench_tick_p99.py serving``: the Pallas
  kernels in interpret mode on the JAX side, their plain versions in the
  port) at B = 2: instance 0 the default scenario from the stand, instance 1
  walking (v_cmd 0.1 m/s) with the gait started 0.26 s before, so that the
  period holds the first left swing (lift-off, swing references, the gait
  clock's gates). The port runs both as one batch with per-instance gait
  fields; the JAX side one jitted period per instance.
* The configs and scenarios, field by field; the entry points' device.
* The default configuration's period (matmul inverses, kernel B1's plain
  version in the port) at B = 2 is the same comparison; it is marked
  ``slow``: its JAX reference takes over two minutes of XLA compilation.

Tolerances. A period is closed-loop: the WBID QP's solution moves by up to
~1e-2 N under rounding-level changes of its inputs (the JAX package's own
jitted and eager runs of one tick differ by that much at float64), so the
period's forces and torques are held to the golden test's tolerances
(``tests/test_golden.py``: forces 0.5 N, torques 5e-2 N m, CoM 1e-4 m) and
the contact sequence exactly; the MPC's plan (once per period, open loop)
to 1e-6 relative. The MPC stage's delay modes and the tick's optional
branches are held open-loop in ``tests/test_torch_engine_stages.py``.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.engine import tick as jeng
from g1_locomotion_tpu.ops import pallas_lin
from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.engine import tick as teng
from g1_locomotion_tpu_torch.models.robot import load_robot

CPU = torch.device("cpu")
F64 = torch.float64
TOL = dict(com=1e-4, tau=5e-2, forces=5e-1)  # tests/test_golden.py
ATOL_OPEN = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _interpret():
    gj, gji, admm = pallas_lin.gj_solve, pallas_lin.gj_inverse, pallas_lin.admm_iterate
    return (mock.patch.object(pallas_lin, "gj_solve", lambda K, b: gj(K, b, interpret=True)),
            mock.patch.object(pallas_lin, "gj_inverse", lambda K: gji(K, interpret=True)),
            mock.patch.object(pallas_lin, "admm_iterate",
                              lambda *a, **kw: admm(*a, **kw, interpret=True)))


def serving_config(cfg):
    return cfg._replace(
        mpc=cfg.mpc._replace(qp=cfg.mpc.qp._replace(polish_kernel=True)),
        wbid=cfg.wbid._replace(qp=cfg.wbid.qp._replace(polish_kernel=True), fast_stack=True))


def _scenarios():
    """The two instances' JAX ScenarioParams."""
    p0 = jeng.default_scenario(jnp.float64)
    p1 = p0._replace(gait=p0.gait._replace(start_time=jnp.asarray(-0.26)),
                     v_cmd=jnp.asarray([0.1, 0.0]))
    return p0, p1


def _stack(trees):
    """Per-instance JAX params as one port ScenarioParams: the fields that
    differ get a batch axis, the others stay shared."""
    def join(*xs):
        xs = [np.asarray(x) for x in xs]
        return xs[0] if all(np.array_equal(xs[0], x) for x in xs[1:]) else np.stack(xs)

    return convert.scenario_params(jax.tree_util.tree_map(join, *trees), device=CPU, dtype=F64)


def _period_case(g1, cfg):
    ro = jeng.make_rollout(g1, cfg)
    run = jax.jit(lambda s, p: ro(s, p, 1))
    state = jeng.init_state(g1, cfg, jnp.float64)
    scen = _scenarios()
    with _interpret()[0], _interpret()[1], _interpret()[2]:
        refs = [_np(run(state, p)) for p in scen]
    model = load_robot("g1_23dof", device=CPU, dtype=F64)
    loop = teng.ControlLoop(model, convert.engine_config(cfg._asdict()))
    tstate = teng.init_state(model, loop.cfg, 2, F64)
    return loop, tstate, _stack(scen), refs


def _check_period(got_state, got_log, refs):
    for b, (fin, log) in enumerate(refs):
        for name in ("com", "tau", "forces"):
            g, r = getattr(got_log, name)[b, 0].numpy(), log._asdict()[name][0]
            err = float(np.abs(g - r).max())
            print(f"instance {b} {name}: max abs err {err:.3e} (<= {TOL[name]})")
            assert err <= TOL[name], (b, name, err)
        np.testing.assert_array_equal(got_log.contact[b, 0].numpy(), log.contact[0])
        for name in ("plan_x1", "plan_u0", "landing", "mpc_pri_res"):
            g, r = getattr(got_log, name)[b, 0].numpy(), log._asdict()[name][0]
            err = float(np.abs(g - r).max() / max(np.abs(r).max(), 1.0))
            print(f"instance {b} {name}: max rel err {err:.3e} (<= {ATOL_OPEN})")
            assert err <= ATOL_OPEN, (b, name, err)
        for name in ("q", "gait_clock", "landing", "swing_start", "anchors"):
            g, r = getattr(got_state, name)[b].numpy(), np.asarray(getattr(fin, name))
            assert float(np.abs(g - r).max()) <= TOL["com"], (b, name)
    # The walking instance really swung: its left contacts went inactive.
    assert float(got_log.contact[1, 0, :, 0].min()) == 0.0
    assert float(got_log.contact[0, 0].min()) == 1.0


def test_serving_period_matches_jax(g1):
    cfg = serving_config(jeng.EngineConfig())
    loop, state, params, refs = _period_case(g1, cfg)
    fin, log = loop.rollout(state, params, 1)
    assert log.tau.shape == (2, 1, 40, 23) and log.q.shape == (2, 1, 40, 0)
    _check_period(fin, log, refs)


@pytest.mark.slow
def test_default_period_matches_jax(g1):
    loop, state, params, refs = _period_case(g1, jeng.EngineConfig())
    fin, log = loop.rollout(state, params, 1)
    _check_period(fin, log, refs)


def test_configs_and_scenarios_match_jax():
    """The port's configs and scenarios are the JAX package's, field by field."""
    for name in ("walking_config", "walking_config_f32"):
        assert getattr(teng, name)() == convert.engine_config(getattr(jeng, name)()._asdict())
    assert teng.EngineConfig() == convert.engine_config(jeng.EngineConfig()._asdict())
    for name, kwargs in (("default_scenario", {}),
                         ("walking_scenario", dict(n_steps=6.0, v_cmd=(0.2, 0.0))),
                         ("walking_scenario", dict(v_cmd=(0.05, 0.0))),
                         ("walking_scenario_f32_robust", {}),
                         ("stale_walking_scenario", {})):
        ref = convert.scenario_params(_np(getattr(jeng, name)(jnp.float64, **kwargs)),
                                      device=CPU, dtype=F64)
        got = getattr(teng, name)(device=CPU, dtype=F64, **kwargs)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
            assert a.shape == b.shape and torch.equal(a.nan_to_num(), b.nan_to_num()), name


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """Without a device the entry points take the card (and raise without
    one); a CPU device is the caller's explicit choice."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.default_scenario()
