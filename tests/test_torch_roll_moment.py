"""MPCConfig.roll_moment_max of the PyTorch port against the JAX package.

The cap adds one row a knot, |sum_i (r_ik x f_ik)_x| <= roll_moment_max,
and with footstep_opt a d_y column (the landing's summed fz of the
linearization forces). Two cases at float64, each with the cap at 5 N m
(so that it binds):

* bench.py's workload (N = 10, B = 6: standing, left swing, right swing,
  the CoM moved in x and y) in the serving QP configuration
  (``polish_kernel``): m = 200 + 10 = 210 rows, the port's plain versions
  of B2-B4 against the JAX package's Pallas kernels in interpret mode;
* footstep_opt with the swing-momentum preview at the walk's horizon (N =
  20) on the MPC inputs the JAX planner makes at the states the validated
  walk visits (tests/torch_walk_states.py), warm-started, on the walk's
  factorization path.

build_qp's H, g, A, l, u within 1e-12 of their scale; the solve's u0
within 1e-6 of its scale, d within 1e-9 m and the predicted states within
1e-6 (measured maxima in CHANGES.md). The cap must bind somewhere, or the
rows would not be tested.
"""

import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.engine import tick as jeng
from g1_locomotion_tpu.gait import planner as jpl
from g1_locomotion_tpu.models import srbd as jsrbd
from g1_locomotion_tpu.mpc import solver as jmpc
from g1_locomotion_tpu.ops import pallas_lin
from g1_locomotion_tpu.ops.qp import QPConfig as JQPConfig
from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.mpc import solver as tmpc

CPU, F64 = torch.device("cpu"), torch.float64
CAP = 5.0
RTOL_QP, RTOL_U0, ATOL_D, ATOL_X = 1e-12, 1e-6, 1e-9, 1e-6


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _bench_case():
    """bench.py's workload at N = 10, B = 6 (as tests/test_torch_mpc.py)."""
    B, N = 6, 10
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
    inputs = (x0s, np.tile(x0, (B, N, 1)), np.stack([stand, left_up, right_up])[np.arange(B) % 3],
              np.tile(feet, (B, N, 1, 1)), np.tile(com, (B, N, 1)))
    cfg = jmpc.MPCConfig(horizon=N, roll_moment_max=CAP, qp=JQPConfig(
        iters=20, scaling_iters=0, rho=1.0, rho_segments=2, polish_rounds=2,
        iter_precision="high", polish_kernel=True))
    dt = jnp.float64
    return cfg, jmpc.default_weights(dt), jsrbd.default_params(dt), inputs, {}


def _walk_case():
    """footstep_opt + hdot_sw at N = 20 on the walk's states, warm-started
    from a cold solve (as tests/test_torch_mpc.py's footstep test)."""
    sys.path.insert(0, str(Path(__file__).parent))
    import torch_walk_states

    S = torch_walk_states.split()
    scen = jeng.walking_scenario(jnp.float64, n_steps=8.0, v_cmd=(0.1, 0.0))
    params = scen.srbd._replace(m_swing=jnp.asarray(1.0, jnp.float64))
    plan = jax.vmap(lambda x0, cpos, c, ss: jpl.plan_horizon(
        scen.gait, scen.steps, scen.v_cmd, x0, cpos, c, 20, 0.04, 0.598, swing_start=ss))(
        S["x0"], S["cpos"], S["gait_clock"], S["swing_start"])
    inputs = tuple(np.asarray(x) for x in (S["x0"], plan.x_ref, plan.contact_hor, plan.c_hor,
                                            plan.p_ref))
    cfg = jmpc.MPCConfig(horizon=20, footstep_opt=True, roll_moment_max=CAP, qp=JQPConfig(
        iters=60, scaling_iters=0, rho=1.0, rho_segments=2, polish_rounds=3,
        matmul_inverse=False))
    cold = jax.jit(jax.vmap(lambda *a: jmpc.solve(cfg._replace(roll_moment_max=0.0),
                                                  scen.mpc_weights, params, *a)))(*inputs)
    extra = {"U_warm": np.asarray(cold.U), "landing_mask": np.asarray(plan.landing_mask),
             "hdot_sw": np.asarray(plan.hdot_geom)}
    return cfg, scen.mpc_weights, params, inputs, extra


CASES = {"serving": _bench_case, "footstep_opt": _walk_case}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    cfg, weights, params, inputs, extra = CASES[request.param]()
    names = tuple(extra)

    @jax.jit
    def jsolve(args, extras):
        return jax.vmap(lambda a, e: jmpc.solve(cfg, weights, params, *a, **dict(zip(names, e))))(
            args, extras)

    gj, gji, admm = pallas_lin.gj_solve, pallas_lin.gj_inverse, pallas_lin.admm_iterate
    with mock.patch.object(pallas_lin, "gj_solve", lambda K, b: gj(K, b, interpret=True)), \
            mock.patch.object(pallas_lin, "gj_inverse", lambda K: gji(K, interpret=True)), \
            mock.patch.object(pallas_lin, "admm_iterate",
                              lambda *a, **kw: admm(*a, **kw, interpret=True)):
        ref = jsolve(inputs, tuple(extra.values()))
    return dict(name=request.param, cfg=cfg, weights=weights, params=params, inputs=inputs,
                extra=extra, ref=ref, tcfg=convert.mpc_config(cfg._asdict()),
                tw=convert.mpc_weights(weights._asdict(), device=CPU, dtype=F64),
                tp=convert.srbd_params(params._asdict(), device=CPU, dtype=F64))


def _qp_extras(case):
    """build_qp's keyword inputs as solve() makes them (f_nom: the warm start)."""
    extra = case["extra"]
    if not case["cfg"].footstep_opt:
        return {}
    U = extra["U_warm"]
    return {"landing_mask": extra["landing_mask"], "f_nom": U.reshape(U.shape[:2] + (4, 3)),
            "hdot_sw": extra["hdot_sw"]}


def test_build_qp_matches_jax(case):
    cfg, kw = case["cfg"], _qp_extras(case)
    want = jax.vmap(lambda a, e: jmpc.build_qp(cfg, case["weights"], case["params"], *a, **e))(
        case["inputs"], kw)
    got = tmpc.build_qp(case["tcfg"], case["tw"], case["tp"], *(_t(x) for x in case["inputs"]),
                        **{k: _t(v) for k, v in kw.items()})
    N = cfg.horizon
    assert got[2].shape[-2] == 20 * N + N + (2 if cfg.footstep_opt else 0)
    worst = 0.0
    for name, g, w in zip(("H", "g", "A", "l", "u"), got[:5], want[:5]):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-300))
        worst = max(worst, err)
        assert err <= RTOL_QP, (name, err)
    print(f"{case['name']}: build_qp max relative error {worst:.2e}")


def test_solve_matches_jax(case):
    cfg, ref = case["cfg"], case["ref"]
    sol = tmpc.solve(case["tcfg"], case["tw"], case["tp"], *(_t(x) for x in case["inputs"]),
                     **{k: _t(v) for k, v in case["extra"].items()})
    u0 = np.asarray(ref.u0)
    du0 = float(np.abs(sol.u0.numpy() - u0).max() / np.abs(u0).max())
    dd = float(np.abs(sol.d.numpy() - np.asarray(ref.d)).max())
    dx = float(np.abs(sol.x_horizon.numpy() - np.asarray(ref.x_horizon)).max())
    # The cap binds: some knot's roll moment sits at it (within the ADMM's
    # residual), so the rows shape the solution. They are the last N rows.
    A = tmpc.build_qp(case["tcfg"], case["tw"], case["tp"], *(_t(x) for x in case["inputs"]),
                      **{k: _t(v) for k, v in _qp_extras(case).items()})[2]
    x = sol.U.flatten(1)
    if cfg.footstep_opt:
        x = torch.cat([x, sol.d / cfg.d_scale], dim=-1)
    moment = float((A[:, -cfg.horizon:] @ x[..., None]).abs().max())
    print(f"{case['name']}: |du0| {du0:.2e} (relative), |dd| {dd:.2e} m, |dx| {dx:.2e}; "
          f"largest |roll moment| {moment:.3f} N m (cap {CAP})")
    assert du0 <= RTOL_U0 and dd <= ATOL_D and dx <= ATOL_X
    assert moment >= 0.99 * CAP
    assert all(torch.isfinite(v).all() for v in sol)


def test_capped_serving_qp_takes_the_register_kernels():
    """With the cap, the serving QP (N = 10) has m = 210 rows: past the
    float32 register tiles of B3 (m <= 208) and of B4 with 13 rows of A a
    thread (m <= 208), so on the card B3 runs its two-CTA cluster tile and B4
    its tile with 14 rows a thread, both in registers; neither takes a
    shared-memory kernel any more (ops/cuda_lin.py's plans; chip_smoke.py
    phases 1 and 3 run them)."""
    from g1_locomotion_tpu_torch.ops import cuda_lin

    assert cuda_lin.gj_plan("gj_solve", 200, torch.float32) == ("tile", 0)
    assert cuda_lin.gj_plan("gj_solve", 210, torch.float32) == ("cluster", 0)
    assert cuda_lin.admm_plan(120, 200, torch.float32) == ("tile13", 0)
    assert cuda_lin.admm_plan(120, 210, torch.float32) == ("tile14", 0)
    assert cuda_lin.gj_plan("gj_inverse", 120, torch.float32) == ("tile", 0)
