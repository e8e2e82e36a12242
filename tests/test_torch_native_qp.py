"""ops/native_qp.py of the PyTorch port (its own ctypes binding of
native/qp_solver.cpp) against the JAX package's binding of the same source,
and the port's batched ADMM (ops/qp.solve_qp) against that native IPM
oracle, on the CPU at float64.

* The two bindings on the seeded problems of ``tests/test_native_qp.py``
  (same source, same flags): x and y within 1e-12 (measured: bit-equal).
* ``solve_qp`` against the IPM at a WBID-like size (n = 41, m = 100, six
  equality rows, ``QPConfig(iters=150)``): atol 5e-5, as
  ``tests/test_native_qp.py:57-69`` holds the JAX ADMM (measured 1.1e-9);
  and at the MPC's size (the condensed QP of ``MPCConfig()`` for a
  standing, a left-swing and a right-swing horizon: n = 120, m = 200) in
  ``MPCConfig().qp``: standing within 1e-4 of the IPM's x relative to its
  largest force (measured 1.0e-5); with a foot swinging, the ADMM and its
  polish stop short of the optimum, in both packages alike, so there the
  port is held to the JAX package's ``solve_qp`` (1e-10 relative) and the
  objective to within 2% of the IPM's (measured 0.35% and 1.6%).
* The port's library lives under ``g1_locomotion_tpu_torch/_build/``, named
  by a hash of the source; the binding never writes ``native/``.
"""

import numpy as np
import pytest
import torch

from g1_locomotion_tpu.ops import native_qp as jnative
from g1_locomotion_tpu_torch.models import srbd
from g1_locomotion_tpu_torch.mpc import solver as mpc
from g1_locomotion_tpu_torch.ops import native_qp
from g1_locomotion_tpu_torch.ops import qp as qplib

from test_qp import random_qp

F64 = torch.float64


def _problem(seed, n, m, eq_rows=4):
    return tuple(np.asarray(a) for a in random_qp(np.random.default_rng(seed), n=n, m=m,
                                                    eq_rows=eq_rows))


# (seed, n, m, equality rows, solve arguments) of tests/test_native_qp.py.
CASES = [(s, 20, 30, 4, {}) for s in range(5)] + [
    (7, 30, 50, 5, dict(max_iter=100, tol=1e-8)), (9, 16, 20, 6, {}), (3, 41, 100, 6, {})]


@pytest.mark.parametrize("seed,n,m,eq_rows,kwargs", CASES)
def test_binding_matches_jax_binding(seed, n, m, eq_rows, kwargs):
    P, q, A, l, u = _problem(seed, n, m, eq_rows)
    got = native_qp.solve(P, q, A, l, u, **kwargs)
    ref = jnative.solve(P, q, A, l, u, **kwargs)
    assert got.status == ref.status == 0 and got.iters == ref.iters
    print(f"seed {seed}: |dx| {np.abs(got.x - ref.x).max():.3e}, |dy| "
          f"{np.abs(got.y - ref.y).max():.3e} (<= 1e-12)")
    np.testing.assert_allclose(got.x, ref.x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.y, ref.y, rtol=0, atol=1e-12)


def test_build_location():
    path = native_qp.build()
    assert path.parent == native_qp.BUILD_DIR and path.name.startswith("libqp_solver_")
    assert "native" not in path.parent.parts[-1]
    with pytest.raises(ValueError, match="shapes"):
        native_qp.solve(np.eye(3), np.zeros(2), np.eye(3), np.zeros(3), np.ones(3))


def test_solve_qp_matches_native_wbid_like():
    P, q, A, l, u = _problem(3, 41, 100, eq_rows=6)
    ref = native_qp.solve(P, q, A, l, u)
    assert ref.status == 0
    sol = qplib.solve_qp(*(torch.tensor(a, dtype=F64)[None] for a in (P, q, A, l, u)),
                         cfg=qplib.QPConfig(iters=150))
    err = float(np.abs(sol.x[0].numpy() - ref.x).max())
    print(f"solve_qp vs native IPM, n = 41, m = 100: max |dx| {err:.3e} (<= 5e-5)")
    assert err <= 5e-5


def test_solve_qp_against_native_mpc():
    """The MPC's condensed QP (MPCConfig(): N = 10, 120 variables, 200 rows)
    for three contact patterns, solved as one batch by the port's solve_qp in
    MPCConfig().qp, each against the IPM and against the JAX package's
    solve_qp."""
    import jax

    from g1_locomotion_tpu.ops import qp as jqp

    cfg = mpc.MPCConfig()
    N, dev = cfg.horizon, torch.device("cpu")
    x0 = torch.zeros(13, dtype=F64)
    x0[3:6] = torch.tensor([0.0527, 0.0, 0.598], dtype=F64)
    x0[12] = srbd.GRAVITY
    feet = torch.tensor([[-0.05, 0.12, 0.0], [0.12, 0.12, 0.0], [-0.05, -0.12, 0.0],
                         [0.12, -0.12, 0.0]], dtype=F64)
    contact = torch.ones((3, N, 4), dtype=F64)
    contact[1, :5, :2] = 0.0  # left foot swinging for the first five knots
    contact[2, 3:, 2:] = 0.0  # right foot lifting after three
    x0s = x0.repeat(3, 1)
    x0s[:, 4] += torch.tensor([0.0, 0.02, -0.02], dtype=F64)
    H, g, A, l, u, *_ = mpc.build_qp(cfg, mpc.default_weights(device=dev, dtype=F64),
                                     srbd.default_params(device=dev, dtype=F64), x0s,
                                     x0.repeat(N, 1), contact, feet.repeat(N, 1, 1),
                                     x0[3:6].repeat(N, 1))
    assert H.shape == (3, 120, 120) and A.shape == (3, 200, 120)
    sol = qplib.solve_qp(H, g, A, l, u, cfg=cfg.qp)
    jsolve = jax.jit(lambda *a: jqp.solve_qp(*a, cfg=jqp.QPConfig(**cfg.qp._asdict())).x)
    for b in range(3):
        Hb, gb, Ab, lb, ub = (t[b].numpy() for t in (H, g, A, l, u))
        x = sol.x[b].numpy()
        jx = np.asarray(jsolve(Hb, gb, Ab, lb, ub))
        ref = native_qp.solve(Hb, gb, Ab, lb, ub)
        assert ref.status == 0, ref.status
        obj = [0.5 * v @ Hb @ v + gb @ v for v in (x, ref.x)]
        gap = (obj[0] - obj[1]) / abs(obj[1])
        err_jax = float(np.abs(x - jx).max() / np.abs(jx).max())
        err = float(np.abs(x - ref.x).max() / np.abs(ref.x).max())
        print(f"MPC QP, contact pattern {b}: vs the JAX solve_qp {err_jax:.3e} (<= 1e-10); vs "
              f"the IPM max |dx| / max |x| {err:.3e}, objective {gap:.3e} above the optimum")
        assert err_jax <= 1e-10
        assert -1e-12 <= gap <= (1e-8 if b == 0 else 0.02)
        if b == 0:
            assert err <= 1e-4
