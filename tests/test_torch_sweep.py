"""parallel/sweep.py and the per-instance scenario parameters of the PyTorch
port, on the CPU at float64.

* ``randomize``: shapes, ranges, the inertia scaled by the mass's own draw
  (as the reference: ``tests/test_parallel.py``), and
  ``convert.scenario_batch`` on the JAX package's randomized batch: the
  randomized leaves per instance, every other leaf shared.
* Per-instance SRBD mass and inertia and WBID mu: one period of a batch of
  three against each instance run alone with its values shared, on the
  plain and on the fast WBID assembly.
* ``run_sweep``'s statistics against the JAX package's ``run_sweep`` on the
  JAX package's ``randomize(SweepSpec(8), PRNGKey(0))`` batch, 2 periods of
  ``tests/test_telemetry.py``'s tiny configuration: ``n`` and
  ``fell_count`` exact, the drift and tau_max to 1e-9 relative.
* A chunked sweep (two chunks of one period, the engine states, statistics,
  drift origin and lowest heights through ``utils/checkpoint`` between
  them) against the unchunked run, exactly.

The JAX package's sweep is computed once for the module (~45 s of XLA
compilation on a CPU). The per-instance rollout against the JAX package is
in ``tests/test_torch_sweep_batch.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.engine import tick as jeng
from g1_locomotion_tpu.mpc.solver import MPCConfig as JMPCConfig
from g1_locomotion_tpu.ops.qp import QPConfig as JQPConfig
from g1_locomotion_tpu.parallel import sweep as jsweep
from g1_locomotion_tpu.wbid.solver import WBIDConfig as JWBIDConfig
from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.engine import tick as teng
from g1_locomotion_tpu_torch.models.robot import load_robot
from g1_locomotion_tpu_torch.parallel import sweep as tsweep
from g1_locomotion_tpu_torch.utils import checkpoint

CPU = torch.device("cpu")
F64 = torch.float64
B = 8
PERIODS = 2
RTOL = 1e-9
RANDOMIZED = {("srbd", "mass"), ("srbd", "inertia"), ("wbid_gains", "mu"),
              ("gait", "swing_duration"), ("steps", "step_length"), ("v_cmd",)}


def tiny_cfg(telemetry: bool = False) -> jeng.EngineConfig:
    """tests/test_telemetry.py's tiny configuration (the JAX package's)."""
    return jeng.EngineConfig(
        mpc=JMPCConfig(horizon=4, qp=JQPConfig(iters=12, scaling_iters=0, rho=1.0,
                                               rho_segments=1, polish=False)),
        wbid=JWBIDConfig(qp=JQPConfig(iters=10, scaling_iters=0, rho=0.1, rho_segments=1,
                                      polish=False)),
        ticks_per_mpc=4, telemetry=telemetry,
    )


def jax_batch():
    """The JAX package's randomized batch, every leaf (B, ...), as numpy."""
    params = jsweep.randomize(jsweep.SweepSpec(n_scenarios=B), jax.random.PRNGKey(0),
                              jeng.default_scenario(jnp.float64))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_sweep(g1):
    params = jax_batch()
    _, (com_start, min_z), stats = jsweep.run_sweep(g1, tiny_cfg(), params, PERIODS)
    return params, jax.tree_util.tree_map(np.asarray, (com_start, min_z, stats))


@pytest.fixture(scope="module")
def model():
    return load_robot("g1_23dof", device=CPU, dtype=F64)


def _paths(params):
    for group, value in params._asdict().items():
        if isinstance(value, torch.Tensor):
            yield (group,), value
        else:
            for name, leaf in value._asdict().items():
                yield (group, name), leaf


def test_randomize_shapes_and_ranges():
    base = teng.default_scenario(device=CPU, dtype=F64)
    spec = tsweep.SweepSpec(n_scenarios=32)
    params = tsweep.randomize(spec, torch.Generator().manual_seed(0), base)
    assert params.v_cmd.shape == (32, 2) and params.batch() == 32
    assert params.srbd.mass.shape == (32,) and params.srbd.inertia.shape == (32, 3, 3)
    shared = dict(_paths(base))
    for path, leaf in _paths(params):
        if path not in RANDOMIZED:
            assert torch.equal(leaf.nan_to_num(), shared[path].nan_to_num()), path
    for lohi, x in ((spec.v_cmd_x, params.v_cmd[:, 0]), (spec.v_cmd_y, params.v_cmd[:, 1]),
                    (spec.friction, params.wbid_gains.mu),
                    (spec.swing_duration, params.gait.swing_duration),
                    (spec.step_length, params.steps.step_length),
                    (spec.mass_scale, params.srbd.mass / base.srbd.mass)):
        assert float(x.min()) >= lohi[0] and float(x.max()) <= lohi[1]
        assert float(x.max() - x.min()) > 0.5 * (lohi[1] - lohi[0])
    # The inertia is scaled by the mass's own draw (the reference draws both
    # with one key).
    scale = params.srbd.mass / base.srbd.mass
    torch.testing.assert_close(params.srbd.inertia, base.srbd.inertia * scale[:, None, None],
                               rtol=1e-15, atol=0)
    # The same seed draws the same batch; the draws are the generator's.
    again = tsweep.randomize(spec, torch.Generator().manual_seed(0), base)
    assert torch.equal(again.v_cmd, params.v_cmd)


def test_scenario_batch_of_the_jax_batch():
    ref = jax_batch()
    params = convert.scenario_batch(ref, device=CPU, dtype=F64)
    shared = dict(_paths(teng.default_scenario(device=CPU, dtype=F64)))
    for path, leaf in _paths(params):
        if path in RANDOMIZED:
            want = ref
            for name in path:
                want = getattr(want, name)
            assert leaf.shape[0] == B
            np.testing.assert_array_equal(leaf.numpy(), want)
        else:
            assert torch.equal(leaf.nan_to_num(), shared[path].nan_to_num()), path
    # A leaf the port takes only shared must not differ between instances.
    bad = ref._replace(mpc_weights=ref.mpc_weights._replace(
        Q=ref.mpc_weights.Q * np.arange(1, B + 1)[:, None]))
    with pytest.raises(ValueError, match="mpc_weights.Q"):
        convert.scenario_batch(bad, device=CPU, dtype=F64)


@pytest.mark.parametrize("fast_stack", [False, True])
def test_per_instance_parameters_equal_instances_alone(model, fast_stack):
    """A batch with per-instance SRBD mass, inertia and WBID mu runs each
    instance as that instance alone with its values shared."""
    cfg = convert.engine_config(tiny_cfg()._asdict())
    cfg = cfg._replace(wbid=cfg.wbid._replace(fast_stack=fast_stack))
    base = teng.default_scenario(device=CPU, dtype=F64)
    scale = torch.tensor([0.9, 1.0, 1.1], dtype=F64)
    mu = torch.tensor([0.5, 0.8, 1.0], dtype=F64)
    params = base._replace(
        srbd=base.srbd._replace(mass=base.srbd.mass * scale,
                                inertia=base.srbd.inertia * scale[:, None, None]),
        wbid_gains=base.wbid_gains._replace(mu=mu),
        v_cmd=torch.tensor([[0.1, 0.0], [0.0, 0.05], [-0.1, 0.0]], dtype=F64))
    loop = teng.ControlLoop(model, cfg)
    _, log = loop.rollout(teng.init_state(model, cfg, 3, F64), params, 2)
    for b in range(3):
        alone = params.rows(slice(b, b + 1))
        alone = alone._replace(srbd=alone.srbd._replace(mass=alone.srbd.mass[0],
                                                        inertia=alone.srbd.inertia[0]),
                               wbid_gains=alone.wbid_gains._replace(mu=alone.wbid_gains.mu[0]))
        _, ref = loop.rollout(teng.init_state(model, cfg, 1, F64), alone, 2)
        for name in ("com", "tau", "forces", "plan_u0", "plan_x1"):
            got, want = getattr(log, name)[b], getattr(ref, name)[0]
            # Products at B = 3 and at B = 1 round apart, and the QPs of the
            # closed loop amplify it (measured 5.1e-11); a wrong mass or mu
            # moves these by percents.
            err = float((got - want).abs().max() / want.abs().max().clamp_min(1.0))
            assert err <= RTOL, (b, name, err)


def test_run_sweep_matches_jax(jax_sweep, model):
    ref_params, (ref_start, ref_min_z, ref) = jax_sweep
    params = convert.scenario_batch(ref_params, device=CPU, dtype=F64)
    loop = teng.ControlLoop(model, convert.engine_config(tiny_cfg()._asdict()))
    _, (com_start, min_z), stats = tsweep.run_sweep(loop, params, PERIODS)
    print({k: (float(getattr(stats, k)), float(getattr(ref, k))) for k in stats._fields})
    assert float(stats.n) == float(ref.n) == B
    assert float(stats.fell_count) == float(ref.fell_count)
    for name in ("com_drift_sum", "tau_max"):
        got, want = float(getattr(stats, name)), float(getattr(ref, name))
        assert abs(got - want) <= RTOL * abs(want), (name, got, want)
    np.testing.assert_allclose(com_start.numpy(), ref_start, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(min_z.numpy(), ref_min_z, rtol=RTOL)


def test_chunked_resume_equals_unchunked(model, tmp_path):
    """Two chunks of one period, resumed through a checkpoint, give the
    statistics of one unchunked run of two periods exactly
    (tests/test_sweep_resume.py's check, through run_sweep)."""
    loop = teng.ControlLoop(model, convert.engine_config(tiny_cfg()._asdict()))
    params = tsweep.randomize(tsweep.SweepSpec(n_scenarios=4), torch.Generator().manual_seed(1),
                              teng.default_scenario(device=CPU, dtype=F64))
    final, (start, min_z), whole = tsweep.run_sweep(loop, params, 2)

    s1, (ref1, z1), st1 = tsweep.run_sweep(loop, params, 1)
    path = str(tmp_path / "sweep")
    checkpoint.save(path, (s1, st1, ref1, z1), meta={"chunk": 1})
    (s1, st1, ref1, z1), meta = checkpoint.restore(path, (s1, st1, ref1, z1))
    assert meta == {"chunk": 1}
    s2, (_, z2), st2 = tsweep.run_sweep(loop, params, 1, states0=s1, com_ref=ref1)
    assert torch.equal(st2.n, whole.n)
    assert torch.equal(st2.com_drift_sum, whole.com_drift_sum)
    assert torch.equal(torch.maximum(st1.tau_max, st2.tau_max), whole.tau_max)
    assert torch.equal(torch.minimum(z1, z2), min_z) and torch.equal(ref1, start)
    assert torch.equal(s2.q, final.q)
