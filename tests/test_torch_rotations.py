"""core/rotations.py of the PyTorch port against the JAX package.

The cases of tests/test_rotations.py; every input is made with numpy from a
seed and handed to both packages at float64. Tolerance 1e-12 absolute: the
functions are a few closed-form trigonometric / polynomial ops on unit-scale
values, so the two frameworks differ by rounding only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.core import rotations as jrot
from g1_locomotion_tpu_torch.core import rotations as trot

ATOL = 1e-12


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _both(fn_name, *args):
    """Run ``fn_name`` of both packages on the same numpy inputs."""
    arrays = [isinstance(a, np.ndarray) for a in args]
    j = np.asarray(getattr(jrot, fn_name)(*(jnp.asarray(a) if arr else a
                                            for a, arr in zip(args, arrays))))
    t = getattr(trot, fn_name)(*(torch.tensor(a) if arr else a
                                 for a, arr in zip(args, arrays))).numpy()
    return j, t


@pytest.mark.parametrize(
    "fn_name, make_args",
    [
        ("skew", lambda rng: (rng.normal(size=(16, 3)),)),
        ("quat_normalize", lambda rng: (rng.normal(size=(64, 4)),)),
        ("quat_to_matrix", lambda rng: (_quats(rng),)),
        ("matrix_to_quat", lambda rng: (np.asarray(jrot.quat_to_matrix(jnp.asarray(_quats(rng)))),)),
        ("quat_mul", lambda rng: (_quats(rng), _quats(rng))),
        ("quat_conj", lambda rng: (_quats(rng),)),
        ("quat_rotate", lambda rng: (_quats(rng), rng.normal(size=(64, 3)))),
        ("quat_from_axis_angle", lambda rng: (_quats(rng)[:, 1:], rng.uniform(-3, 3, size=64))),
        ("rpy_to_matrix", lambda rng: (rng.uniform([-3, -1.4, -3], [3, 1.4, 3], size=(128, 3)),)),
        ("matrix_to_rpy", lambda rng: (np.asarray(jrot.quat_to_matrix(jnp.asarray(_quats(rng)))),)),
        ("quat_to_rpy", lambda rng: (_quats(rng),)),
        ("rpy_to_quat", lambda rng: (rng.uniform([-3, -1.4, -3], [3, 1.4, 3], size=(128, 3)),)),
        ("yaw_matrix", lambda rng: (rng.uniform(-4, 4, size=(5, 7)),)),
        ("wxyz_from_xyzw", lambda rng: (_quats(rng),)),
        ("xyzw_from_wxyz", lambda rng: (_quats(rng),)),
        ("quat_integrate", lambda rng: (_quats(rng), rng.normal(size=(64, 3)), 0.01)),
    ],
)
def test_matches_jax(rng, fn_name, make_args):
    j, t = _both(fn_name, *make_args(rng))
    assert j.shape == t.shape
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


def test_quat_matrix_roundtrip(rng):
    q = torch.as_tensor(_quats(rng))
    q2 = trot.matrix_to_quat(trot.quat_to_matrix(q))
    qc = torch.where(q[..., :1] < 0, -q, q)
    np.testing.assert_allclose(q2.numpy(), qc.numpy(), atol=ATOL)


def test_matrix_orthonormal(rng):
    R = trot.quat_to_matrix(torch.as_tensor(_quats(rng)))
    eye = np.broadcast_to(np.eye(3), R.shape)
    np.testing.assert_allclose((R @ R.mT).numpy(), eye, atol=ATOL)
    np.testing.assert_allclose(torch.linalg.det(R).numpy(), 1.0, atol=ATOL)


def test_rpy_roundtrip(rng):
    rpy = rng.uniform(low=[-3, -1.4, -3], high=[3, 1.4, 3], size=(128, 3))
    rpy2 = trot.matrix_to_rpy(trot.rpy_to_matrix(torch.as_tensor(rpy)))
    np.testing.assert_allclose(rpy2.numpy(), rpy, atol=ATOL)


def test_rpy_matches_tf_convention():
    # tf.transformations.euler_matrix(0.1, 0.2, 0.3)[:3, :3] ('sxyz').
    R = trot.rpy_to_matrix(torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64)).numpy()
    expected = np.array(
        [
            [0.93629336, -0.27509585, 0.21835066],
            [0.28962948, 0.95642509, -0.03695701],
            [-0.19866933, 0.0978434, 0.97517033],
        ]
    )
    np.testing.assert_allclose(R, expected, atol=1e-8)


def test_skew_cross(rng):
    a = torch.as_tensor(rng.normal(size=(16, 3)))
    b = torch.as_tensor(rng.normal(size=(16, 3)))
    np.testing.assert_allclose(
        (trot.skew(a) @ b[..., None])[..., 0].numpy(),
        torch.linalg.cross(a, b).numpy(),
        atol=ATOL,
    )


def test_quat_integrate_constant_rate():
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    w = torch.tensor([0.0, 0.0, np.pi / 2], dtype=torch.float64)  # 90 deg/s about z
    for _ in range(100):
        q = trot.quat_integrate(q, w, 0.01)
    np.testing.assert_allclose(trot.quat_to_rpy(q).numpy(), [0.0, 0.0, np.pi / 2], atol=1e-9)
