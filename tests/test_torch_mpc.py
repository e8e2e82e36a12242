"""The slice as a whole: mpc/solver.py of the PyTorch port against the JAX
``jax.vmap(mpc.solve)`` on the ``bench.py`` workload.

N = 10, B = 6 instances cycling through the standing, left-swing and
right-swing contact patterns of bench.py, x0 perturbed with numpy from a
seed. Parameters and weights come from the JAX package's ``default_params``
and ``default_weights`` through ``convert``. Two QP configurations:

* throughput (bench.py): 20 ADMM iterations, 2 rho segments, 2 polish
  rounds, matmul inverse — the port's inverses end in kernel B1's plain
  version on the CPU;
* serving (tools/bench_latency.py): the same with ``polish_kernel`` — the
  port runs the plain versions of B2, B3 and B4, the JAX side its Pallas
  kernels in interpret mode.

Compared at float64: u0, U and x_horizon to atol 1e-6 (forces are ~335 N;
both sides run the same algorithm, so they agree to rounding unless an
active-set decision flips, which would show as a large error), and the
residuals pri_res / dua_res to atol 1e-8 (they are ~1e-10 / ~1e-7).
Each JAX reference is compiled and run once per module: the throughput
configuration alone costs about a minute of XLA compile on the CPU.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.models import srbd as jsrbd
from g1_locomotion_tpu.mpc import solver as jmpc
from g1_locomotion_tpu.ops import pallas_lin
from g1_locomotion_tpu.ops.qp import QPConfig as JQPConfig
from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.mpc import solver as tmpc

B, N = 6, 10
CPU = torch.device("cpu")
F64 = torch.float64
ATOL_TRAJ = 1e-6
ATOL_RES = 1e-8

_QP = dict(iters=20, scaling_iters=0, rho=1.0, rho_segments=2, polish_rounds=2,
           iter_precision="high")
JAX_CONFIGS = {
    "throughput": jmpc.MPCConfig(horizon=N, qp=JQPConfig(**_QP)),
    "serving": jmpc.MPCConfig(horizon=N, qp=JQPConfig(**_QP, polish_kernel=True)),
    "serving_mb2": jmpc.MPCConfig(horizon=N, move_block=2,
                                  qp=JQPConfig(**_QP, polish_kernel=True)),
}


def _bench_inputs():
    """bench.py's workload in numpy: standing CoM, four foot contacts, mixed
    contact patterns, lateral and sagittal CoM perturbations."""
    rng = np.random.default_rng(0)
    com = np.array([0.0527, 0.0, 0.598])
    feet = np.array([[-0.05, 0.12, 0.0], [0.12, 0.12, 0.0],
                     [-0.05, -0.12, 0.0], [0.12, -0.12, 0.0]])
    x0 = np.zeros(13)
    x0[3:6] = com
    x0[12] = jsrbd.GRAVITY
    stand = np.ones((N, 4))
    left_up, right_up = stand.copy(), stand.copy()
    left_up[:, :2] = 0.0
    right_up[:, 2:] = 0.0
    x0s = np.tile(x0, (B, 1))
    x0s[:, 4] += rng.uniform(-0.03, 0.03, B)
    x0s[:, 3] += rng.uniform(-0.02, 0.02, B)
    return dict(
        x0=x0s,
        x_ref=np.tile(x0, (N, 1)),
        contact=np.stack([stand, left_up, right_up])[np.arange(B) % 3],
        c_hor=np.tile(feet, (N, 1, 1)),
        p_hor=np.tile(com, (N, 1)),
    )


def _jax_solve(cfg, inp):
    w = jmpc.default_weights(jnp.float64)
    p = jsrbd.default_params(jnp.float64)
    x_ref, c_hor, p_hor = (jnp.asarray(inp[k]) for k in ("x_ref", "c_hor", "p_hor"))
    fn = jax.jit(jax.vmap(lambda x, c: jmpc.solve(cfg, w, p, x, x_ref, c, c_hor, p_hor)))
    gj, gji, admm = pallas_lin.gj_solve, pallas_lin.gj_inverse, pallas_lin.admm_iterate
    with mock.patch.object(pallas_lin, "gj_solve", lambda K, b: gj(K, b, interpret=True)), \
            mock.patch.object(pallas_lin, "gj_inverse", lambda K: gji(K, interpret=True)), \
            mock.patch.object(pallas_lin, "admm_iterate",
                              lambda *a, **kw: admm(*a, **kw, interpret=True)):
        sol = fn(jnp.asarray(inp["x0"]), jnp.asarray(inp["contact"]))
    return {k: np.asarray(v) for k, v in sol._asdict().items()}


@pytest.fixture(scope="module")
def slice_case():
    inp = _bench_inputs()
    jw = jmpc.default_weights(jnp.float64)
    jp = jsrbd.default_params(jnp.float64)
    port = dict(
        weights=convert.mpc_weights({k: np.asarray(v) for k, v in jw._asdict().items()},
                                    device=CPU, dtype=F64),
        params=convert.srbd_params({k: np.asarray(v) for k, v in jp._asdict().items()},
                                   device=CPU, dtype=F64),
        inputs={k: torch.tensor(v, dtype=F64) for k, v in inp.items()},
    )
    # Each configuration's JAX reference is compiled on first use, so that no
    # one test pays for all three XLA compiles.
    refs = functools.cache(lambda name: _jax_solve(JAX_CONFIGS[name], inp))
    return port, refs


def _port_solve(port, name):
    cfg = convert.mpc_config(JAX_CONFIGS[name]._asdict())
    t = port["inputs"]
    return tmpc.solve(cfg, port["weights"], port["params"], t["x0"], t["x_ref"],
                      t["contact"], t["c_hor"], t["p_hor"])


@pytest.mark.parametrize("name", list(JAX_CONFIGS))
def test_slice_matches_jax(slice_case, name):
    port, refs = slice_case
    ref = refs(name)
    sol = _port_solve(port, name)
    for key in ("u0", "U", "x_horizon"):
        got = getattr(sol, key).numpy()
        assert got.shape == ref[key].shape, key
        np.testing.assert_allclose(got, ref[key], rtol=0, atol=ATOL_TRAJ, err_msg=key)
    for key in ("pri_res", "dua_res"):
        np.testing.assert_allclose(getattr(sol, key).numpy(), ref[key], rtol=0,
                                   atol=ATOL_RES, err_msg=key)


@pytest.mark.parametrize("name", ["throughput", "serving"])
def test_slice_invariants(slice_case, name):
    """The physical invariants the chip drive checks: standing instances carry
    m*g, swing contacts carry exactly 0, the constraint residual is tiny."""
    port, _ = slice_case
    sol = _port_solve(port, name)
    contact = port["inputs"]["contact"]
    fz = sol.u0[:, 2::3]
    standing = contact[:, 0].sum(dim=-1) == 4
    mg = jsrbd.G1_MASS * -jsrbd.GRAVITY
    np.testing.assert_allclose(fz[standing].sum(dim=-1).numpy(), mg, rtol=1e-2)
    swing = contact[:, 0].repeat_interleave(3, dim=-1) == 0
    assert torch.all(sol.u0[swing] == 0)
    assert float(sol.pri_res.max()) < 0.05
    assert all(torch.isfinite(getattr(sol, k)).all() for k in ("u0", "U", "x_horizon"))


def test_module_matches_function(slice_case):
    """MPCSolver holds parameters and weights as buffers and calls solve()."""
    port, _ = slice_case
    cfg = convert.mpc_config(JAX_CONFIGS["throughput"]._asdict())
    module = tmpc.MPCSolver(cfg, port["weights"], port["params"])
    assert {n for n, _ in module.named_buffers()} == {"Q", "R", "mass", "inertia", "m_swing"}
    t = port["inputs"]
    got = module(t["x0"], t["x_ref"], t["contact"], t["c_hor"], t["p_hor"])
    want = _port_solve(port, "throughput")
    assert torch.equal(got.u0, want.u0) and torch.equal(got.x_horizon, want.x_horizon)


def test_warm_start_from_the_plan_keeps_the_solution(slice_case):
    """U_warm feeds the QP's x0 (knot-subsampled, as in the reference): warm
    started from the JAX plan, the port lands on the same first-step forces
    (1e-4 N: 20 warm iterations move the ADMM point, the polish restores it)."""
    port, refs = slice_case
    cfg = convert.mpc_config(JAX_CONFIGS["serving_mb2"]._asdict())
    t = port["inputs"]
    U_warm = torch.tensor(refs("serving_mb2")["U"])
    sol = tmpc.solve(cfg, port["weights"], port["params"], t["x0"], t["x_ref"],
                     t["contact"], t["c_hor"], t["p_hor"], U_warm=U_warm)
    np.testing.assert_allclose(sol.u0.numpy(), refs("serving_mb2")["u0"], atol=1e-4)


@pytest.mark.parametrize("feature", ["footstep_opt", "roll_moment_max", "hdot_sw"])
def test_unported_features_raise(slice_case, feature):
    """The three features the port once refused: footstep_opt, the hdot_sw
    preview and the roll-moment cap (roll_moment_max > 0, measured negative
    in the reference) are ported; each runs and gives finite plans (held
    against the JAX package below and in tests/test_torch_roll_moment.py)."""
    port, _ = slice_case
    cfg = tmpc.MPCConfig()
    kwargs = {}
    if feature == "footstep_opt":
        cfg = cfg._replace(footstep_opt=True)
    elif feature == "roll_moment_max":
        cfg = cfg._replace(roll_moment_max=20.0)
    else:
        kwargs["hdot_sw"] = torch.zeros((B, N, 3), dtype=F64)
    t = port["inputs"]
    args = (cfg, port["weights"], port["params"], t["x0"], t["x_ref"], t["contact"],
            t["c_hor"], t["p_hor"])
    sol = tmpc.solve(*args, **kwargs)
    assert all(torch.isfinite(x).all() for x in sol)


# footstep_opt and the swing-momentum preview, at the walk's horizon (N = 20:
# 242 variables, 402 rows), on MPC inputs that the JAX planner makes at the
# states the validated walk visits (tests/torch_walk_states.py), with a
# swing-limb mass of 1 kg so that the preview acts, on the walk's QP path
# (walking_config: the factorization path; the JAX package's matmul-inverse
# path at this size takes minutes of XLA compilation on a CPU). u0 within
# 1e-6 N, d within 1e-9 m and the predicted states within 1e-6 (measured
# maxima in CHANGES.md).
FOOTSTEP_CONFIGS = {
    "factorization": jmpc.MPCConfig(
        horizon=20, footstep_opt=True,
        qp=JQPConfig(iters=60, scaling_iters=0, rho=1.0, rho_segments=2, polish_rounds=3,
                     matmul_inverse=False)),
}


@pytest.mark.parametrize("name", list(FOOTSTEP_CONFIGS))
def test_footstep_opt_and_swing_preview_match_jax(name):
    import sys
    from pathlib import Path

    from g1_locomotion_tpu.engine import tick as jeng
    from g1_locomotion_tpu.gait import planner as jpl

    sys.path.insert(0, str(Path(__file__).parent))
    import torch_walk_states

    cfg = FOOTSTEP_CONFIGS[name]
    S = torch_walk_states.split()
    scen = jeng.walking_scenario(jnp.float64, n_steps=8.0, v_cmd=(0.1, 0.0))
    params = scen.srbd._replace(m_swing=jnp.asarray(1.0, jnp.float64))
    weights = scen.mpc_weights
    plan = jax.vmap(lambda x0, cpos, c, ss: jpl.plan_horizon(
        scen.gait, scen.steps, scen.v_cmd, x0, cpos, c, 20, 0.04, 0.598, swing_start=ss))(
        S["x0"], S["cpos"], S["gait_clock"], S["swing_start"])
    inputs = (S["x0"], plan.x_ref, plan.contact_hor, plan.c_hor, plan.p_ref)

    @jax.jit
    def jsolve(U_warm, lm, hd, *args):
        return jax.vmap(lambda u, m, h, *a: jmpc.solve(cfg, weights, params, *a, U_warm=u,
                                                       landing_mask=m, hdot_sw=h))(
            U_warm, lm, hd, *args)

    # A cold solve gives the warm start (the d x f linearization's forces).
    cold = jsolve(jnp.zeros((len(S["x0"]), 20, 12)), plan.landing_mask, plan.hdot_geom, *inputs)
    ref = jsolve(cold.U, plan.landing_mask, plan.hdot_geom, *inputs)
    assert float(np.abs(np.asarray(ref.d)).max()) > 1e-4  # the offset is in use
    assert float(np.abs(np.asarray(plan.hdot_geom)).max()) > 0.1  # so is the preview

    t = lambda x: torch.tensor(np.asarray(x), dtype=F64)  # noqa: E731
    sol = tmpc.solve(convert.mpc_config(cfg._asdict()),
                     convert.mpc_weights(weights._asdict(), device=CPU, dtype=F64),
                     convert.srbd_params(params._asdict(), device=CPU, dtype=F64),
                     *(t(x) for x in inputs), U_warm=t(cold.U),
                     landing_mask=t(plan.landing_mask), hdot_sw=t(plan.hdot_geom))
    du0 = float(np.abs(sol.u0.numpy() - np.asarray(ref.u0)).max())
    dd = float(np.abs(sol.d.numpy() - np.asarray(ref.d)).max())
    dx = float(np.abs(sol.x_horizon.numpy() - np.asarray(ref.x_horizon)).max())
    print(f"{name}: |du0| {du0:.2e} N, |dd| {dd:.2e} m, |dx_horizon| {dx:.2e}")
    assert du0 <= 1e-6 and dd <= 1e-9 and dx <= 1e-6
