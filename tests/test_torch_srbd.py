"""models/srbd.py of the PyTorch port against the JAX package.

N = 10 horizon with a batch of 3 different instances. The JAX functions are
single-instance; they are vmapped over the batch, the port takes it as a
leading dimension. Inputs come from numpy with a seed, compared at float64
to 1e-12 relative (plus 1e-12 absolute for entries that are exactly 0 on
one side): both sides evaluate the same closed-form products and sums, so
they differ only by rounding, and the largest entries (the condensed B_qp
over 10 steps) are O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.models import srbd as jsrbd
from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.models import srbd as tsrbd

B, N = 3, 10
DT = 0.04
RTOL, ATOL = 1e-12, 1e-12
CPU = torch.device("cpu")


def _close(t: torch.Tensor, j) -> None:
    j = np.asarray(j)
    assert tuple(t.shape) == j.shape
    np.testing.assert_allclose(t.numpy(), j, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    jp = jsrbd.default_params(jnp.float64)._replace(m_swing=jnp.asarray(1.3))
    return {
        "jp": jp,
        "tp": convert.srbd_params({k: np.asarray(v) for k, v in jp._asdict().items()},
                                  device=CPU, dtype=torch.float64),
        "yaw": rng.uniform(-np.pi, np.pi, size=(B, N)),
        "r": rng.normal(scale=0.2, size=(B, N, jsrbd.NC, 3)),
        "x0": rng.normal(size=(B, jsrbd.NX)),
        "U": rng.normal(scale=50.0, size=(B, N, jsrbd.NU)),
        "f": rng.normal(scale=100.0, size=(B, N, 3)),
        "d": rng.normal(scale=0.02, size=(B, 2)),
    }


def _jax_mats(case):
    step = jax.vmap(jax.vmap(lambda y, r: jsrbd.continuous_matrices(case["jp"], y, r)))
    return step(jnp.asarray(case["yaw"]), jnp.asarray(case["r"]))


def _torch_mats(case):
    T = torch.as_tensor
    return tsrbd.continuous_matrices(case["tp"], T(case["yaw"]), T(case["r"]))


def test_params_match():
    jp = jsrbd.default_params(jnp.float64)
    tp = tsrbd.default_params(device=CPU, dtype=torch.float64)
    _close(tp.mass, jp.mass)
    _close(tp.inertia, jp.inertia)
    jr = jsrbd.reference_parity_params(jnp.float64)
    tr = tsrbd.reference_parity_params(device=CPU, dtype=torch.float64)
    _close(tr.inertia, jr.inertia)


def test_continuous_matrices(case):
    (jA, jB), (tA, tB) = _jax_mats(case), _torch_mats(case)
    _close(tA, jA)
    _close(tB, jB)


def test_discretize(case):
    jAd, jBd = jax.vmap(jax.vmap(lambda a, b: jsrbd.discretize(a, b, DT)))(*_jax_mats(case))
    tAd, tBd = tsrbd.discretize(*_torch_mats(case), DT)
    _close(tAd, jAd)
    _close(tBd, jBd)


def test_condense_and_rollout(case):
    jAd, jBd = jax.vmap(jax.vmap(lambda a, b: jsrbd.discretize(a, b, DT)))(*_jax_mats(case))
    tAd, tBd = tsrbd.discretize(*_torch_mats(case), DT)
    jAqp, jBqp = jax.vmap(jsrbd.condense)(jAd, jBd)
    tAqp, tBqp = tsrbd.condense(tAd, tBd)
    _close(tAqp, jAqp)
    _close(tBqp, jBqp)

    x0, U = case["x0"], case["U"]
    jx = jax.vmap(jsrbd.rollout)(jAd, jBd, jnp.asarray(x0), jnp.asarray(U))
    tx = tsrbd.rollout(tAd, tBd, torch.as_tensor(x0), torch.as_tensor(U))
    _close(tx, jx)
    # The condensed map and the rollout agree: X = A_qp x0 + B_qp U.
    X = (tAqp @ tx.new_tensor(x0)[..., None] + tBqp @ tx.new_tensor(U).reshape(B, -1, 1))[..., 0]
    np.testing.assert_allclose(X.numpy(), tx[:, 1:].reshape(B, -1).numpy(), rtol=1e-10, atol=1e-10)


def test_affine_and_landing_terms(case):
    """landing_sensitivity, swing_disturbance, discretize_affine, lift_affine
    and the rollout's E d / w terms."""
    jp, tp = case["jp"], case["tp"]
    yaw, f, d = case["yaw"], case["f"], case["d"]
    T = torch.as_tensor
    jE = jax.vmap(jax.vmap(lambda y, fs: jsrbd.landing_sensitivity(jp, y, fs)))(
        jnp.asarray(yaw), jnp.asarray(f))
    tE = tsrbd.landing_sensitivity(tp, T(yaw), T(f))
    _close(tE, jE)

    jw = jax.vmap(jax.vmap(lambda y, h: jsrbd.swing_disturbance(jp, y, h)))(
        jnp.asarray(yaw), jnp.asarray(f))
    tw = tsrbd.swing_disturbance(tp, T(yaw), T(f))
    _close(tw, jw)

    jA, jB = _jax_mats(case)
    tA, tB = _torch_mats(case)
    jwd = jax.vmap(jax.vmap(lambda a, w: jsrbd.discretize_affine(a, w, DT)))(jA, jw)
    twd = tsrbd.discretize_affine(tA, tw, DT)
    _close(twd, jwd)

    jAd, jBd = jax.vmap(jax.vmap(lambda a, b: jsrbd.discretize(a, b, DT)))(jA, jB)
    tAd, tBd = tsrbd.discretize(tA, tB, DT)
    _close(tsrbd.lift_affine(tAd, twd), jax.vmap(jsrbd.lift_affine)(jAd, jwd))

    jEd = jax.vmap(jax.vmap(lambda a, e: jsrbd.discretize(a, e, DT)[1]))(jA, jE)
    tEd = tsrbd.discretize(tA, tE, DT)[1]
    _close(tEd, jEd)
    jx = jax.vmap(lambda a, b, x, u, e, dd, w: jsrbd.rollout(a, b, x, u, Ed=e, d=dd, wd=w))(
        jAd, jBd, jnp.asarray(case["x0"]), jnp.asarray(case["U"]), jEd, jnp.asarray(d), jwd)
    tx = tsrbd.rollout(tAd, tBd, T(case["x0"]), T(case["U"]), Ed=tEd, d=T(d), wd=twd)
    _close(tx, jx)
