"""models/dynamics.py of the PyTorch port against the JAX package and MuJoCo,
on the CPU at float64.

The same numpy states (B = 4, random base poses and joints, random
velocities and accelerations, from a seed) go through ``jax.vmap`` of the
JAX package's ``rnea``, ``bias_force``, ``gravity_force``, ``crba`` and
``forward_dynamics`` (jitted once per variant) and through the port's
batch-first functions. Tolerance: rtol 1e-11 against the largest entry of
the reference (measured ~1e-15; forward dynamics, a solve with M, ~1e-13).
The port's ``rnea`` is also held against MuJoCo's ``mj_inverse`` on the
exported MJCF of the same asset, as tests/test_dynamics.py holds the JAX
package's (atol 1e-5).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.models import dynamics as jdyn
from g1_locomotion_tpu.models import robot as jrb
from g1_locomotion_tpu_torch.models import dynamics as tdyn
from g1_locomotion_tpu_torch.models import robot as trb

RTOL = 1e-11
B = 4
CPU = torch.device("cpu")
F64 = torch.float64


def close(got, ref, rtol, label=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    err = float(np.abs(got - ref).max() / max(float(np.abs(ref).max()), 1.0))
    print(f"{label}: max rel err {err:.2e}")
    assert err <= rtol, (label, err)


def random_states(nj, seed):
    rng = np.random.default_rng(seed)
    q = np.zeros((B, 7 + nj))
    q[:, :3] = rng.normal(size=(B, 3)) * 0.5
    quat = rng.normal(size=(B, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = rng.normal(size=(B, nj)) * 0.6
    return q, rng.normal(size=(B, 6 + nj)), rng.normal(size=(B, 6 + nj))


_CACHE = {}


def variant_case(variant):
    """(port model, torch inputs, the JAX package's outputs), once per variant."""
    if variant not in _CACHE:
        jm = jrb.load_robot(variant, dtype=jnp.float64)
        q, v, a = random_states(jm.nj, seed=len(_CACHE) + 1)

        def one(q, v, a):
            return dict(rnea=jdyn.rnea(jm, q, v, a), bias=jdyn.bias_force(jm, q, v),
                        grav=jdyn.gravity_force(jm, q), crba=jdyn.crba(jm, q),
                        fd=jdyn.forward_dynamics(jm, q, v, a))

        ref = jax.jit(jax.vmap(one))(jnp.asarray(q), jnp.asarray(v), jnp.asarray(a))
        _CACHE[variant] = (trb.load_robot(variant, device=CPU, dtype=F64),
                           tuple(torch.tensor(x) for x in (q, v, a)),
                           {k: np.asarray(x) for k, x in ref.items()})
    return _CACHE[variant]


@pytest.mark.parametrize("variant", trb.VARIANTS)
def test_rnea_and_crba_match_jax(variant):
    tm, (q, v, a), ref = variant_case(variant)
    close(tdyn.rnea(tm, q, v, a), ref["rnea"], RTOL, f"{variant} rnea")
    close(tdyn.crba(tm, q), ref["crba"], RTOL, f"{variant} crba")


def test_bias_gravity_forward_dynamics_match_jax():
    tm, (q, v, a), ref = variant_case("g1_23dof")
    X = trb.fk(tm, q)
    close(tdyn.bias_force(tm, q, v), ref["bias"], RTOL, "bias_force")
    close(tdyn.bias_force(tm, q, v, body_X=X), ref["bias"], RTOL, "bias_force, FK given")
    close(tdyn.gravity_force(tm, q), ref["grav"], RTOL, "gravity_force")
    close(tdyn.forward_dynamics(tm, q, v, a), ref["fd"], RTOL, "forward_dynamics")


def test_rnea_is_mass_matrix_plus_bias():
    """rnea(q, v, a) = M(q) a + h(q, v), and forward dynamics inverts it."""
    tm, (q, v, a), _ = variant_case("g1_23dof")
    tau = tdyn.rnea(tm, q, v, a)
    Ma = (tdyn.crba(tm, q) @ a[..., None])[..., 0]
    close(Ma + tdyn.bias_force(tm, q, v), tau, 1e-12, "M a + h")
    close(tdyn.forward_dynamics(tm, q, v, tau), a, 1e-10, "forward_dynamics(rnea)")


@pytest.fixture(scope="module")
def mj_model():
    mujoco = pytest.importorskip("mujoco")
    from g1_locomotion_tpu.models.mjcf import export_mjcf
    from g1_locomotion_tpu.models.urdf import spec_from_dict

    asset = Path(jrb.__file__).parent / "assets" / "g1_23dof.json"
    spec = spec_from_dict(json.loads(asset.read_text()))
    return mujoco, mujoco.MjModel.from_xml_string(export_mjcf(spec))


def _mj_inverse(mujoco, m, q, v, a):
    """mj_inverse in this package's conventions (tests/test_dynamics.py):
    MuJoCo's free joint takes [v_world, w_local] and returns [f_world,
    n_local]; ours is [v_local, w_local] and [f_local, n_local]."""
    d = mujoco.MjData(m)
    w = q[3:7]
    x, y, z = w[1], w[2], w[3]
    w0 = w[0]
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w0 * z), 2 * (x * z + w0 * y)],
                  [2 * (x * y + w0 * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w0 * x)],
                  [2 * (x * z - w0 * y), 2 * (y * z + w0 * x), 1 - 2 * (x * x + y * y)]])
    d.qpos[:] = q
    d.qvel[:3] = R @ v[:3]
    d.qvel[3:] = v[3:]
    d.qacc[:3] = R @ (a[:3] + np.cross(v[3:6], v[:3]))
    d.qacc[3:] = a[3:]
    mujoco.mj_inverse(m, d)
    tau = d.qfrc_inverse.copy()
    tau[:3] = R.T @ tau[:3]
    return tau


def test_rnea_vs_mujoco(mj_model):
    mujoco, m = mj_model
    tm = trb.load_robot("g1_23dof", device=CPU, dtype=F64)
    rng = np.random.default_rng(7)
    q = np.zeros((5, tm.nq))
    q[:, 2] = 0.7
    quat = rng.normal(size=(5, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = rng.normal(size=(5, tm.nj)) * 0.3
    v = rng.normal(size=(5, tm.nv))
    a = rng.normal(size=(5, tm.nv))
    v[0] = a[0] = 0.0  # the static case first
    ours = tdyn.rnea(tm, torch.tensor(q), torch.tensor(v), torch.tensor(a)).numpy()
    for i in range(5):
        np.testing.assert_allclose(ours[i], _mj_inverse(mujoco, m, q[i], v[i], a[i]), atol=1e-5)
