"""A domain-randomized batch through the PyTorch port's control period,
against the JAX package's rollout of each instance, on the CPU at float64.

The JAX package's ``randomize(SweepSpec(8), PRNGKey(0))`` batch (SRBD mass
and inertia, WBID mu, swing duration, step length and v_cmd per instance)
goes through ``convert.scenario_batch`` into one port batch of 8 and one
period of ``tests/test_telemetry.py``'s tiny configuration; the JAX side
runs its ``make_rollout`` per instance (vmapped, as its ``run_sweep``
does). Tolerances as ``tests/test_torch_engine.py``'s: the closed loop's
forces, torques and CoM to ``tests/test_golden.py``'s (0.5 N, 5e-2 N m,
1e-4 m), the contact flags exactly, the MPC's plan to 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from g1_locomotion_tpu.engine import tick as jeng
from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.engine import tick as teng
from g1_locomotion_tpu_torch.models.robot import load_robot
from test_torch_sweep import B, jax_batch, tiny_cfg

CPU = torch.device("cpu")
F64 = torch.float64
TOL = dict(com=1e-4, tau=5e-2, forces=5e-1)  # tests/test_golden.py
RTOL_PLAN = 1e-6


def test_randomized_batch_matches_jax_per_instance(g1):
    ref_params = jax_batch()
    cfg = tiny_cfg()
    rollout = jeng.make_rollout(g1, cfg)
    state = jeng.init_state(g1, cfg, jnp.float64)
    fin_ref, log_ref = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.vmap(lambda p: rollout(state, p, 1)))(ref_params))

    model = load_robot("g1_23dof", device=CPU, dtype=F64)
    tcfg = convert.engine_config(cfg._asdict())
    params = convert.scenario_batch(ref_params, device=CPU, dtype=F64)
    assert params.srbd.mass.shape == (B,) and params.wbid_gains.mu.shape == (B,)
    loop = teng.ControlLoop(model, tcfg)
    fin, log = loop.rollout(teng.init_state(model, tcfg, B, F64), params, 1)

    for name, tol in TOL.items():
        err = float(np.abs(getattr(log, name).numpy() - getattr(log_ref, name)).max())
        print(f"{name}: max abs err {err:.3e} (<= {tol})")
        assert err <= tol, (name, err)
    np.testing.assert_array_equal(log.contact.numpy(), log_ref.contact)
    for name in ("plan_x1", "plan_u0", "landing", "mpc_pri_res"):
        got, want = getattr(log, name).numpy(), getattr(log_ref, name)
        err = (np.abs(got - want).reshape(B, -1).max(axis=1)
               / np.maximum(np.abs(want).reshape(B, -1).max(axis=1), 1.0))
        print(f"{name}: max rel err per instance {err.max():.3e} (<= {RTOL_PLAN})")
        assert err.max() <= RTOL_PLAN, (name, err)
    for name in ("q", "v", "gait_clock", "landing"):
        err = float(np.abs(getattr(fin, name).numpy() - getattr(fin_ref, name)).max())
        assert err <= TOL["com"], (name, err)
