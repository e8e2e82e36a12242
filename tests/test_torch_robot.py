"""models/robot.py (and core/spatial, models/urdf, engine/state) of the
PyTorch port against the JAX package, on the CPU at float64.

The same numpy states, made from a seed (B = 4: random base poses, joints
within +-0.6 rad, random velocities), go through ``jax.vmap`` of the JAX
functions (jitted once for the module) and through the port's batch-first
functions. Tolerance: rtol 1e-12 against the largest entry of the
reference (both sides do the same float64 arithmetic in another order;
measured ~3e-16). Also: the copied assets are byte-identical, the port's
models equal the JAX package's on every bundled variant, and importing the
port leaves JAX out of ``sys.modules``.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.core import spatial as jsp
from g1_locomotion_tpu.engine import state as jstate
from g1_locomotion_tpu.models import robot as jrb
from g1_locomotion_tpu.models import urdf as jurdf
from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.core import spatial as tsp
from g1_locomotion_tpu_torch.engine import state as tstate
from g1_locomotion_tpu_torch.models import robot as trb
from g1_locomotion_tpu_torch.models import urdf as turdf

RTOL = 1e-12
B = 4
CPU = torch.device("cpu")
F64 = torch.float64
REPO = Path(__file__).resolve().parent.parent


def close(got, ref, rtol, label=""):
    """max |got - ref| <= rtol * max(|ref|, 1): relative to the array's scale."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    err = float(np.abs(got - ref).max() / max(float(np.abs(ref).max()), 1.0))
    print(f"{label}: max rel err {err:.2e}")
    assert err <= rtol, (label, err)


def random_states(nj, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    q = np.zeros((batch, 7 + nj))
    q[:, :3] = rng.normal(size=(batch, 3)) * 0.3
    quat = rng.normal(size=(batch, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = rng.uniform(-0.6, 0.6, (batch, nj))
    return q, rng.normal(size=(batch, 6 + nj))


@pytest.fixture(scope="module")
def tm():
    return trb.load_robot("g1_23dof", device=CPU, dtype=F64)


@pytest.fixture(scope="module")
def case(g1):
    """States, and every kinematic quantity of the JAX package on them
    (one jit for the module)."""
    q, v = random_states(g1.nj)
    idx = [g1.frame_index(n) for n in ("left_foot_line_contact_lower", "right_foot_point_contact",
                                       "pelvis", "left_hand_point_contact", "torso_link")]

    def one(q, v):
        X = jrb.fk(g1, q)
        return dict(
            R=X.R, p=X.p, com=jrb.com_position(g1, X),
            J=jnp.stack([jrb.frame_jacobian(g1, q, X, f) for f in idx]),
            Jb=jrb.frame_jacobians(g1, q, X, idx),
            pose_R=jnp.stack([jrb.frame_pose(g1, X, f).R for f in idx]),
            pose_p=jnp.stack([jrb.frame_pose(g1, X, f).p for f in idx]),
            J_com=jrb.com_jacobian(g1, q, X), v_com=jrb.com_velocity(g1, q, v, X),
            q_next=jrb.integrate_q(g1, q, v, 0.013),
        )

    ref = jax.jit(jax.vmap(one))(jnp.asarray(q), jnp.asarray(v))
    return dict(q=torch.tensor(q), v=torch.tensor(v), idx=idx,
                ref={k: np.asarray(x) for k, x in ref.items()})


def test_fk(tm, case):
    X = trb.fk(tm, case["q"])
    close(X.R, case["ref"]["R"], RTOL, "fk R")
    close(X.p, case["ref"]["p"], RTOL, "fk p")
    close(trb.com_position(tm, X), case["ref"]["com"], RTOL, "com_position")


def test_frame_pose(tm, case):
    X = trb.fk(tm, case["q"])
    poses = [trb.frame_pose(tm, X, f) for f in case["idx"]]
    close(torch.stack([P.R for P in poses], 1), case["ref"]["pose_R"], RTOL, "frame_pose R")
    close(torch.stack([P.p for P in poses], 1), case["ref"]["pose_p"], RTOL, "frame_pose p")


@pytest.mark.parametrize("k", range(5))
def test_frame_jacobian(tm, case, k):
    q = case["q"]
    J = trb.frame_jacobian(tm, q, trb.fk(tm, q), case["idx"][k])
    close(J, case["ref"]["J"][:, k], RTOL, f"frame_jacobian {k}")
    close(trb.point_jacobian(tm, q, trb.fk(tm, q), case["idx"][k]), case["ref"]["J"][:, k, :3],
          RTOL, f"point_jacobian {k}")


def test_frame_jacobians(tm, case):
    q = case["q"]
    close(trb.frame_jacobians(tm, q, trb.fk(tm, q), case["idx"]), case["ref"]["Jb"], RTOL,
          "frame_jacobians")


def test_com_jacobian_and_velocity(tm, case):
    q, v = case["q"], case["v"]
    X = trb.fk(tm, q)
    close(trb.com_jacobian(tm, q, X), case["ref"]["J_com"], RTOL, "com_jacobian")
    close(trb.com_velocity(tm, q, v, X), case["ref"]["v_com"], RTOL, "com_velocity")


def test_integrate_q(tm, case):
    close(trb.integrate_q(tm, case["q"], case["v"], 0.013), case["ref"]["q_next"], RTOL,
          "integrate_q")


@pytest.mark.parametrize("variant", trb.VARIANTS)
def test_assets_are_byte_identical(variant):
    ours = (trb.ASSET_DIR / f"{variant}.json").read_bytes()
    theirs = (Path(jrb.__file__).parent / "assets" / f"{variant}.json").read_bytes()
    assert ours == theirs


def _jax_fields(model):
    import dataclasses

    return {f.name: (np.asarray(getattr(model, f.name))
                     if isinstance(getattr(model, f.name), jnp.ndarray) else getattr(model, f.name))
            for f in dataclasses.fields(model)}


@pytest.mark.parametrize("variant", trb.VARIANTS)
def test_models_equal_on_every_variant(variant):
    """load_robot builds the same model as the JAX package's (synthesized
    contact frames included), and convert.robot_model carries the JAX
    model's fields over to the same tensors."""
    jm = jrb.load_robot(variant, dtype=jnp.float64)
    tm = trb.load_robot(variant, device=CPU, dtype=F64)
    fields = _jax_fields(jm)
    conv = convert.robot_model(fields, device=CPU, dtype=F64)
    for name, value in fields.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(getattr(tm, name).numpy(), value, err_msg=name)
            np.testing.assert_array_equal(getattr(conv, name).numpy(), value, err_msg=name)
        else:
            assert getattr(tm, name) == value == getattr(conv, name), name
    np.testing.assert_array_equal(tm.ancestor.numpy(), np.array(jm.ancestor_mask))
    np.testing.assert_array_equal(conv.ancestor.numpy(), tm.ancestor.numpy())
    assert tm.parent_index.tolist() == list(jm.parent[1:])
    assert (tm.nb, tm.nj, tm.nv, tm.nq) == (jm.nb, jm.nj, jm.nv, jm.nq)


def test_model_to_moves_tensors(tm):
    m32 = tm.to(dtype=torch.float32)
    assert m32.mass.dtype == torch.float32 and m32.parent_index.dtype == torch.long
    assert m32.index((1, 2)).device == CPU and m32.joint_names == tm.joint_names
    np.testing.assert_allclose(m32.inertia.numpy(), tm.inertia.numpy(), rtol=1e-7)


_URDF = """<robot name="two">
  <link name="base"><inertial><origin xyz="0.01 0 0.02" rpy="0 0 0"/><mass value="2.0"/>
    <inertia ixx="0.1" ixy="0" ixz="0" iyy="0.2" iyz="0" izz="0.3"/></inertial></link>
  <link name="arm"><inertial><origin xyz="0 0.1 0" rpy="0.1 0.2 0.3"/><mass value="1.0"/>
    <inertia ixx="0.01" ixy="0.001" ixz="0" iyy="0.02" iyz="0" izz="0.03"/></inertial></link>
  <link name="tip"><inertial><mass value="0.5"/>
    <inertia ixx="0.001" ixy="0" ixz="0" iyy="0.001" iyz="0" izz="0.001"/></inertial></link>
  <joint name="shoulder" type="revolute"><parent link="base"/><child link="arm"/>
    <origin xyz="0 0 0.3" rpy="0 0.5 0"/><axis xyz="0 1 0"/>
    <limit lower="-1" upper="1" effort="10" velocity="5"/></joint>
  <joint name="weld" type="fixed"><parent link="arm"/><child link="tip"/>
    <origin xyz="0.2 0 0" rpy="0 0 0"/></joint>
</robot>"""


def test_parse_urdf_matches():
    """The port's copy of the parser gives the JAX package's spec, and the
    model from the URDF string the same tensors."""
    ours, theirs = turdf.parse_urdf(_URDF), jurdf.parse_urdf(_URDF)
    assert json.dumps(turdf.spec_to_dict(ours)) == json.dumps(jurdf.spec_to_dict(theirs))
    assert turdf.spec_to_dict(turdf.spec_from_dict(turdf.spec_to_dict(ours))) == \
        turdf.spec_to_dict(ours)
    tm = trb.load_robot_from_urdf(_URDF, device=CPU, dtype=F64)
    jm = jrb.load_robot_from_urdf(_URDF, dtype=jnp.float64)
    for name, value in _jax_fields(jm).items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(getattr(tm, name).numpy(), value, err_msg=name)


def test_spatial_algebra(case):
    """core/spatial on batched inputs against the JAX package's functions."""
    rng = np.random.default_rng(3)
    R = case["ref"]["R"][:, 3]  # (B, 3, 3) rotations
    p, m6, f6 = rng.normal(size=(B, 3)), rng.normal(size=(B, 6)), rng.normal(size=(B, 6))
    mass, com = rng.uniform(0.5, 2.0, B), rng.normal(size=(B, 3)) * 0.1
    I_com = np.einsum("bij,bkj->bik", R, R) * 0.01 + np.eye(3) * 0.02
    jX, tX = jsp.Transform(jnp.asarray(R), jnp.asarray(p)), tsp.Transform(torch.tensor(R),
                                                                          torch.tensor(p))
    pairs = [
        (jsp.motion_transform(jX, m6), tsp.motion_transform(tX, torch.tensor(m6))),
        (jsp.motion_transform_inv(jX, m6), tsp.motion_transform_inv(tX, torch.tensor(m6))),
        (jsp.force_transform(jX, f6), tsp.force_transform(tX, torch.tensor(f6))),
        (jsp.force_transform_inv(jX, f6), tsp.force_transform_inv(tX, torch.tensor(f6))),
        (jsp.motion_cross(m6, f6), tsp.motion_cross(torch.tensor(m6), torch.tensor(f6))),
        (jsp.motion_cross_force(m6, f6),
         tsp.motion_cross_force(torch.tensor(m6), torch.tensor(f6))),
        (jX.compose(jX.inverse()).R, tX.compose(tX.inverse()).R),
        (jX.apply(jnp.asarray(p)), tX.apply(torch.tensor(p))),
    ]
    jsi = jsp.spatial_inertia_from_params(jnp.asarray(mass), jnp.asarray(com), jnp.asarray(I_com))
    tsi = tsp.spatial_inertia_from_params(torch.tensor(mass), torch.tensor(com),
                                          torch.tensor(I_com))
    jT, tT = jsp.inertia_transform(jX, jsi), tsp.inertia_transform(tX, tsi)
    jA, tA = jsp.inertia_add(jsi, jT), tsp.inertia_add(tsi, tT)
    pairs += [(jsi.apply(m6), tsi.apply(torch.tensor(m6))), (jsi.to_matrix(), tsi.to_matrix()),
              (jT.I, tT.I), (jT.h, tT.h), (jA.to_matrix(), tA.to_matrix())]
    for k, (ref, got) in enumerate(pairs):
        close(got, ref, RTOL, f"spatial {k}")


def test_standing_state(tm, g1):
    st = tstate.standing_state(tm, batch=3)
    ref = np.asarray(jstate.q_init_standing(g1))
    assert st.q.shape == (3, tm.nq) and st.v.shape == (3, tm.nv)
    np.testing.assert_array_equal(st.q.numpy(), np.tile(ref, (3, 1)))
    assert not st.v.any()


def test_port_imports_no_jax():
    """Importing every module of the port leaves JAX and the JAX package out
    of sys.modules (in a fresh interpreter), and MuJoCo and matplotlib too:
    the bridge and the plots import them when they run (the card's machine
    has neither)."""
    pkg = REPO / "g1_locomotion_tpu_torch"
    modules = sorted("g1_locomotion_tpu_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
                     for p in pkg.rglob("*.py") if p.name != "__init__.py")
    assert "g1_locomotion_tpu_torch.wbid.stack" in modules and len(modules) >= 16
    assert {f"g1_locomotion_tpu_torch.{m}" for m in (
        "models.mjcf", "utils.pd", "engine.mujoco_bridge", "utils.viz", "utils.replay",
        "api.demos", "api.cli")} <= set(modules)
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'g1_locomotion_tpu' or m.startswith('g1_locomotion_tpu.') "
            "or m.split('.')[0] in ('mujoco', 'matplotlib'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
