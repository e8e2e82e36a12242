"""The robot variants on the PyTorch port against the JAX package, on the CPU
at float64: ``srbd.params_from_model`` for all four variants,
``engine.tick.variant_walking_scenario`` / ``variant_walking_config``
field by field, and one MPC stage and one control tick of the 29-DoF
and with-hand cascades (``tests/test_variants.py:70-103``'s case and
checks; against the JAX package's numbers in a ``slow`` case, whose XLA
compiles take ~110 s).

Tolerances: ``params_from_model`` 1e-12 relative; the scenarios 1e-12
relative and the configs equal; the cascade's MPC stage (open loop) 1e-9
relative and the tick's torques 1e-6 N m (the WBID QP's solution moves by
~1e-8 N under rounding-level changes of its inputs). Measured maxima in
CHANGES.md.

``slow``: the four walking bars of ``tools/torch_walk_bar.py`` on the port
(the 23-DoF walk at float64 and the f32 robust walk of
``tests/test_engine_walking.py``, the 29-DoF walk and the with-hand carry
walk of ``tests/test_variants.py``): 120-180 periods each, 6-25 s a period
on a CPU.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.engine import tick as jeng
from g1_locomotion_tpu.engine.state import q_init_standing as jq_init
from g1_locomotion_tpu.models import robot as jrb
from g1_locomotion_tpu.models import srbd as jsrbd
from g1_locomotion_tpu.wbid.stack import StackIndices as JStackIndices
from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.engine import tick as teng
from g1_locomotion_tpu_torch.engine.state import q_init_standing
from g1_locomotion_tpu_torch.models import robot as trb
from g1_locomotion_tpu_torch.models import srbd as tsrbd
from g1_locomotion_tpu_torch.wbid.stack import StackIndices as StackIndex

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

CPU = torch.device("cpu")
F64 = torch.float64
VARIANTS = ("g1_23dof", "g1_29dof", "g1_29dof_with_hand", "g1_dual_arm")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("variant", VARIANTS)
def test_params_from_model_matches_jax(variant):
    jm = jrb.load_robot(variant, dtype=jnp.float64)
    tm = trb.load_robot(variant, device=CPU, dtype=F64)
    ref = jsrbd.params_from_model(jm, jq_init(jm, jnp.float64))
    for q in (q_init_standing(tm, 1), q_init_standing(tm, 1)[0]):
        got = tsrbd.params_from_model(tm, q)
        assert got.mass.shape == () and got.inertia.shape == (3, 3)
        print(f"{variant}: mass rel err {abs(float(got.mass) / float(ref.mass) - 1):.3e}, "
              f"inertia max abs err {np.abs(got.inertia.numpy() - ref.inertia).max():.3e} "
              f"(scale {np.abs(ref.inertia).max():.3f})")
        np.testing.assert_allclose(got.mass.numpy(), np.asarray(ref.mass), rtol=1e-12)
        np.testing.assert_allclose(got.inertia.numpy(), np.asarray(ref.inertia), rtol=1e-12,
                                   atol=1e-12 * float(np.abs(ref.inertia).max()))


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_scenario_and_config_match_jax(variant):
    jm = jrb.load_robot(variant, dtype=jnp.float64)
    tm = trb.load_robot(variant, device=CPU, dtype=F64)
    kwargs = dict(n_steps=6.0, v_cmd=(0.12, 0.0))
    ref = convert.scenario_params(_np(jeng.variant_walking_scenario(jm, jnp.float64, **kwargs)),
                                  device=CPU, dtype=F64)
    got = teng.variant_walking_scenario(tm, dtype=F64, **kwargs)
    worst = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        assert a.device == CPU and a.shape == b.shape
        scale = float(b.nan_to_num().abs().max().clamp_min(1e-300))
        worst = max(worst, float((a - b).nan_to_num().abs().max()) / scale)
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.nan_to_num().abs().max()),
                                   equal_nan=True)
    print(f"{variant}: scenario fields max err relative to each field's scale {worst:.3e} "
          f"(<= 1e-12)")
    assert teng.variant_walking_config(tm) == convert.engine_config(
        jeng.variant_walking_config(jm)._asdict())
    cfg = teng.variant_walking_config(tm)
    assert cfg.torso_task == (variant in ("g1_29dof", "g1_29dof_with_hand"))
    assert cfg.hand_task == (variant == "g1_29dof_with_hand")


def _jax_standing(variant):
    jm = jrb.load_robot(variant, dtype=jnp.float64)
    params = jeng.default_scenario(jnp.float64)
    params = params._replace(gait=params.gait._replace(n_steps=jnp.asarray(0.0, jnp.float64)))
    return jm, jeng.EngineConfig(), params


def _port_cascade_tick(variant):
    """One MPC stage and one control tick of the default EngineConfig on the
    port, standing (n_steps 0): (model, the state after the MPC stage, the
    tick's log)."""
    jm, cfg, params = _jax_standing(variant)
    tm = trb.load_robot(variant, device=CPU, dtype=F64)
    loop = teng.ControlLoop(tm, convert.engine_config(cfg._asdict()))
    tparams = convert.scenario_params(_np(params), device=CPU, dtype=F64)
    tstate, _ = loop._mpc_stage(tparams, teng.init_state(tm, loop.cfg, 1, F64))
    _, tlog = loop._tick(tparams, tstate, (0.0, 1.0))
    return tm, tstate, tlog


@pytest.mark.parametrize("variant", ["g1_29dof", "g1_29dof_with_hand"])
def test_variant_cascade_tick(variant):
    """tests/test_variants.py:70-103's checks on the port, for both variants
    that walk, and their stacks' frames against the JAX package's."""
    jm = jrb.load_robot(variant, dtype=jnp.float64)
    tm, tstate, tlog = _port_cascade_tick(variant)
    ref, got = JStackIndices.from_model(jm), StackIndex.from_model(tm)
    for name in ref._fields:
        assert getattr(got, name) == getattr(ref, name), name
    assert tlog.tau.shape == (1, tm.nj) and bool(torch.isfinite(tlog.tau).all())
    fz = float(tstate.u0[0].reshape(4, 3)[:, 2].sum())
    w = float(tm.total_mass) * 9.80665
    assert 0.3 * w < fz < 1.2 * w, (fz, w)
    assert bool((tlog.tau.abs() <= tm.tau_max + 1e-6).all())


@pytest.mark.slow
def test_29dof_cascade_tick_matches_jax():
    """The 29-DoF case against the JAX package's jitted ``_mpc_stage`` and
    ``_wbid_tick`` (their XLA compiles take ~110 s on a CPU)."""
    jm, cfg, params = _jax_standing("g1_29dof")
    idx = JStackIndices.from_model(jm)
    state = jeng.init_state(jm, cfg, jnp.float64)
    jstate = jax.jit(lambda s: jeng._mpc_stage(jm, idx, cfg, params, s)[0])(state)
    _, jlog = jax.jit(lambda s: jeng._wbid_tick(jm, idx, cfg, params, s,
                                                jnp.asarray(1.0, jnp.float64)))(jstate)
    _, tstate, tlog = _port_cascade_tick("g1_29dof")
    ju0 = np.asarray(jstate.u0)
    err_u0 = float(np.abs(tstate.u0[0].numpy() - ju0).max() / np.abs(ju0).max())
    err_tau = float(np.abs(tlog.tau[0].numpy() - np.asarray(jlog.tau)).max())
    print(f"29-DoF MPC stage u0: max rel err {err_u0:.3e} (<= 1e-9); tick tau: max abs err "
          f"{err_tau:.3e} N m (<= 1e-6)")
    assert err_u0 <= 1e-9 and err_tau <= 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("config", ["walk64", "walk_f32_robust", "g1_29dof",
                                    "g1_29dof_with_hand"])
def test_walk_bar(config):
    import torch_walk_bar as bar

    model, cfg, final, log = bar.walk(config, CPU)
    res = bar.checks(config, model, cfg, final, log)
    failed = {k: v for k, v in res.items() if not v[2]}
    assert not failed, failed
