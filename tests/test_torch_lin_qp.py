"""ops/lin.py and ops/qp.py of the PyTorch port against the JAX package.

* ``chol_inverse`` / ``spd_inverse`` at the sizes the MPC slice inverts
  (30, 60, 120 and 200), batch of 3, float64. On the CPU the JAX recursion
  ends in ``lin._chol_inv_base`` and the port's in the plain version of
  kernel B1. Same recursion, same base-case algorithm: the two agree to
  rounding amplified by cond(K) <= 1e4 (rtol 1e-9, atol 1e-12).
  The recursion works on views of K and W and copies nothing; it is also held
  to the same recursion written with copies and concatenations (rtol 1e-13).
* ``solve_qp``, batch-first, against the JAX ``solve_batch`` (vmap) on the
  random QPs of tests/test_qp.py, in three configurations: the matmul
  inverse; the matmul inverse with ``polish_kernel`` (the JAX Pallas
  kernels in interpret mode); the factorization path with
  ``polish_refine=2``. x, y, pri_res and dua_res agree at rtol 1e-7,
  atol 1e-8, the tolerance tests/test_pallas_lin.py uses between two
  solver paths.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.ops import lin as jlin
from g1_locomotion_tpu.ops import pallas_lin
from g1_locomotion_tpu.ops import qp as jqp
from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.ops import cuda_lin as tcuda_lin
from g1_locomotion_tpu_torch.ops import lin as tlin
from g1_locomotion_tpu_torch.ops import qp as tqp

SIZES = (30, 60, 120, 200)
QP_RTOL, QP_ATOL = 1e-7, 1e-8


def _spd(rng, b, n, cond=1e4):
    Q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    lams = np.exp(rng.uniform(0.0, np.log(cond), size=(b, n)))
    K = np.einsum("bik,bk,bjk->bij", Q, lams, Q)
    return 0.5 * (K + np.swapaxes(K, -1, -2))


@pytest.fixture(scope="module")
def inverses():
    rng = np.random.default_rng(3)
    both = jax.jit(lambda K: (jlin.chol_inverse(K), jlin.spd_inverse(K)))
    out = {}
    for n in SIZES:
        K = _spd(rng, 3, n)
        W, Ki = both(jnp.asarray(K))
        out[n] = (K, np.asarray(W), np.asarray(Ki))
    return out


@pytest.mark.parametrize("n", SIZES)
def test_chol_and_spd_inverse_match_jax(inverses, n):
    K, W_jax, Ki_jax = inverses[n]
    Kt = torch.tensor(K)
    W = tlin.chol_inverse(Kt)
    np.testing.assert_allclose(W.numpy(), W_jax, rtol=1e-9, atol=1e-12)
    Ki = tlin.spd_inverse(Kt)
    np.testing.assert_allclose(Ki.numpy(), Ki_jax, rtol=1e-9, atol=1e-12)
    b = torch.ones((3, n), dtype=torch.float64)
    np.testing.assert_allclose(tlin.spd_solve(Kt, b).numpy(), (Ki @ b[..., None])[..., 0].numpy())


def _chol_inverse_with_copies(K):
    """The recursion as it was before the base case took strided blocks: every
    block made contiguous, W put together with three concatenations a level."""
    n = K.shape[-1]
    if n <= tlin._BASE:
        return tcuda_lin.chol_inverse_base(K.contiguous())
    h = n // 2
    W1 = _chol_inverse_with_copies(K[..., :h, :h])
    L21 = K[..., h:, :h] @ W1.mT
    W2 = _chol_inverse_with_copies(K[..., h:, h:] - L21 @ L21.mT)
    top = torch.cat([W1, K.new_zeros(K.shape[:-2] + (h, n - h))], dim=-1)
    return torch.cat([top, torch.cat([-(W2 @ (L21 @ W1)), W2], dim=-1)], dim=-2)


@pytest.mark.parametrize("n", [120, 200])
def test_chol_inverse_without_copies_equals_the_recursion_with_copies(inverses, n):
    """The copy-free recursion does the same products on views of K and W: it
    agrees with the concatenating one to rtol 1e-13 (a strided operand may take
    another BLAS path, so not bit for bit; atol 1e-13 of the largest entry
    for entries that are sums near zero) and has exact zeros above the
    diagonal; a batch of two leading dimensions gives the same."""
    K = torch.tensor(inverses[n][0])
    W, W_old = tlin.chol_inverse(K), _chol_inverse_with_copies(K)
    assert W.is_contiguous() and W.shape == K.shape
    np.testing.assert_allclose(W.numpy(), W_old.numpy(), rtol=1e-13,
                               atol=1e-13 * float(W_old.abs().max()))
    assert torch.all(torch.triu(W, 1) == 0)
    K4 = torch.stack([K, K.flip(0)])  # (2, 3, n, n)
    assert torch.equal(tlin.chol_inverse(K4)[1], W.flip(0))


def _random_qp(rng, n=20, m=30, eq_rows=4):
    """tests/test_qp.py::random_qp, in numpy."""
    M = rng.normal(size=(n, n))
    P = M @ M.T + 0.5 * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    x_feas = rng.normal(size=n) * 0.3
    Ax = A @ x_feas
    l = Ax - rng.uniform(0.1, 1.0, size=m)
    u = Ax + rng.uniform(0.1, 1.0, size=m)
    l[:eq_rows] = Ax[:eq_rows]
    u[:eq_rows] = Ax[:eq_rows]
    return P, q, A, l, u


CONFIGS = {
    "matmul": jqp.QPConfig(iters=120),
    "polish_kernel": jqp.QPConfig(iters=120, polish_kernel=True),
    "factor_refine": jqp.QPConfig(iters=120, matmul_inverse=False, polish_refine=2),
}


def _interpret_kernels():
    """Patch the JAX Pallas kernels to interpret mode (tests/test_pallas_lin.py)."""
    gj, gji, admm = pallas_lin.gj_solve, pallas_lin.gj_inverse, pallas_lin.admm_iterate
    return (
        mock.patch.object(pallas_lin, "gj_solve", lambda K, b: gj(K, b, interpret=True)),
        mock.patch.object(pallas_lin, "gj_inverse", lambda K: gji(K, interpret=True)),
        mock.patch.object(pallas_lin, "admm_iterate",
                          lambda *a, **kw: admm(*a, **kw, interpret=True)),
    )


@pytest.fixture(scope="module")
def qps():
    """Four random QPs (seeds 0-3) and the JAX solution per configuration."""
    data = [np.stack(x) for x in zip(*(_random_qp(np.random.default_rng(s)) for s in range(4)))]
    # Warm start for one configuration: a perturbed primal guess.
    x0 = np.random.default_rng(9).normal(size=(4, 20)) * 0.1
    sols = {}
    for name, cfg in CONFIGS.items():
        warm = x0 if name == "factor_refine" else None
        p1, p2, p3 = _interpret_kernels()
        with p1, p2, p3:
            fn = jax.jit(lambda P, q, A, l, u, x0, cfg=cfg: jqp.solve_batch(
                P, q, A, l, u, cfg=cfg, x0=x0))
            s = fn(*(jnp.asarray(a) for a in data), None if warm is None else jnp.asarray(warm))
        sols[name] = ({k: np.asarray(v) for k, v in s._asdict().items()}, warm)
    return data, sols


@pytest.mark.parametrize("name", list(CONFIGS))
def test_solve_qp_matches_jax_solve_batch(qps, name):
    data, sols = qps
    jsol, warm = sols[name]
    cfg = convert.qp_config(CONFIGS[name]._asdict())
    P, q, A, l, u = (torch.tensor(a) for a in data)
    x0 = None if warm is None else torch.tensor(warm)
    sol = tqp.solve_qp(P, q, A, l, u, cfg, x0=x0)
    for key in ("x", "y", "z", "pri_res", "dua_res"):
        got = getattr(sol, key).numpy()
        assert got.shape == jsol[key].shape, key
        np.testing.assert_allclose(got, jsol[key], rtol=QP_RTOL, atol=QP_ATOL, err_msg=key)
    # And the KKT residuals of the port's solution are small on every instance.
    pri, dua, comp = tqp.kkt_residuals(P, q, A, l, u, sol.x, sol.y)
    assert float(pri.max()) < 1e-7 and float(dua.max()) < 1e-6 and float(comp.max()) < 1e-6


def test_kkt_residuals_match_jax(qps):
    data, sols = qps
    jsol, _ = sols["matmul"]
    args = [np.asarray(a) for a in data] + [jsol["x"], jsol["y"]]
    want = jax.vmap(jqp.kkt_residuals)(*(jnp.asarray(a) for a in args))
    got = tqp.kkt_residuals(*(torch.tensor(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-13)


def test_iter_precision_has_no_effect(qps):
    """The reference's TPU pass-count knob is carried for config
    compatibility only: it never switches the matmul precision."""
    data, _ = qps
    P, q, A, l, u = (torch.tensor(a) for a in data)
    before = torch.get_float32_matmul_precision()
    hi = tqp.solve_qp(P, q, A, l, u, tqp.QPConfig(iters=40, iter_precision="high"))
    top = tqp.solve_qp(P, q, A, l, u, tqp.QPConfig(iters=40, iter_precision="highest"))
    assert torch.get_float32_matmul_precision() == before == "highest"
    assert torch.equal(hi.x, top.x)
