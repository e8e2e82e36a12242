"""The WBID tick of the PyTorch port (wbid/stack.py, wbid/solver.py,
wbid/ihqp.py, convert) against the JAX package, on the CPU at float64.

Six instances, made with numpy from a seed: double support, left foot
swinging toward a target 5 cm forward and 4 cm up, and right foot swinging,
once perturbed from the standing pose and moving (for the QP blocks) and
once standing still (for the solves; see ``_inputs``). The optional tasks
(torso orientation, hand targets, the leg postural task with its knee floor
at half fade-in) are on, so every block of the stack is compared. One jitted
function computes every JAX reference of an instance (XLA shares the stack
build between them): the QP blocks and the three solve configurations

* default: ``WBIDConfig()`` (matmul inverses; the port's end in kernel B1's
  plain version on the CPU);
* serving: ``polish_kernel=True`` and ``fast_stack=True`` (the port runs the
  plain versions of B2, B3 and B4; the JAX side its Pallas kernels in
  interpret mode);
* strict hierarchy (``wbid/ihqp.py``, the factorization path).

The JAX side assembles every QP with its fast path (``build_qp(fast=True)``;
its own ``tests/test_fast_stack.py`` holds that equal to its default one):
its default assembly would add some 50 s of XLA compilation. Both of the
port's assembly paths are held against it.

Tolerances: QP blocks rtol 1e-10 against each array's largest entry
(measured ~1e-15); the port's fast path against its default path 1e-12;
forces, torques and accelerations atol 1e-6 (N, N m, rad/s^2: both sides
run the same algorithm, so they agree to rounding unless an active-set
decision flips, which would show as a large error). The strict hierarchy is
only defined to ~1 / PIN_RATIO: see ``test_solve_matches_jax_strict``.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.models import robot as jrb
from g1_locomotion_tpu.ops import pallas_lin
from g1_locomotion_tpu.wbid import ihqp as jihqp
from g1_locomotion_tpu.wbid import solver as jsol
from g1_locomotion_tpu.wbid import stack as jstk
from g1_locomotion_tpu.wbid.tasks import WBIDReferences as JRefs
from g1_locomotion_tpu.wbid.tasks import default_gains as jdefault_gains
from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.models import robot as trb
from g1_locomotion_tpu_torch.ops import cuda_lin
from g1_locomotion_tpu_torch.wbid import solver as tsol
from g1_locomotion_tpu_torch.wbid import stack as tstk

CPU = torch.device("cpu")
F64 = torch.float64
RTOL_QP = 1e-10
ATOL_SOL = 1e-6
MG = 34.1329 * 9.80665  # the G1 23-DoF's weight [N] (tests/test_wbid.py)
PATTERNS = ((1.0, 1.0), (0.0, 1.0), (1.0, 0.0))  # contact_active (left, right)

_SERVING_QP = jsol.WBIDConfig().qp._replace(polish_kernel=True)
JAX_CONFIGS = {
    "default": jsol.WBIDConfig(),
    "serving": jsol.WBIDConfig(qp=_SERVING_QP, fast_stack=True),
    "strict": jsol.WBIDConfig(strict_hierarchy=True),
}
BLOCKS = ("H", "g", "C", "l", "u", "M", "h", "Jc_T")
SOLUTION = ("qddot", "forces", "tau", "base_wrench_res", "pri_res")


def close(got, ref, rtol, label=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    err = float(np.abs(got - ref).max() / max(float(np.abs(ref).max()), 1.0))
    print(f"{label}: max rel err {err:.2e}")
    assert err <= rtol, (label, err)


def _inputs(g1, q_stand, idx):
    """Six instances in numpy, the three contact patterns twice: rows 0-2
    perturbed from the standing pose and moving (joints by up to 0.05 rad,
    the base tilted, velocities ~0.1, references off the current pose), for
    the stack's blocks; rows 3-5 standing still at the standing pose with
    references at the current pose, for the solves (the perturbed QPs are
    ill-conditioned enough that a change of rounding moves the strict
    hierarchy's solution by up to ~6 N)."""
    rng = np.random.default_rng(0)
    n = len(PATTERNS)
    q = np.tile(np.asarray(q_stand), (2 * n, 1))
    q[:n, 7:] += rng.uniform(-0.05, 0.05, (n, g1.nj))
    quat = np.concatenate([np.ones((n, 1)), 0.01 * rng.normal(size=(n, 3))], axis=1)
    q[:n, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    v = np.zeros((2 * n, g1.nv))
    v[:n] = rng.normal(size=(n, g1.nv)) * 0.1

    @jax.jit
    def poses(q):
        X = jrb.fk(g1, q)
        feet = [jrb.frame_pose(g1, X, f) for f in idx.feet]
        return dict(foot_p=jnp.stack([P.p for P in feet]), foot_R=jnp.stack([P.R for P in feet]),
                    hands=jnp.stack([jrb.frame_pose(g1, X, f).p for f in idx.hands]),
                    com=jrb.com_position(g1, X), base_R=X.R[0],
                    torso_R=jrb.frame_pose(g1, X, idx.torso).R)

    refs = []
    for i in range(2 * n):
        act, moving = PATTERNS[i % n], i < n
        P = {k: np.asarray(x) for k, x in poses(jnp.asarray(q[i])).items()}
        foot_p, foot_R = P["foot_p"], P["foot_R"]
        swing_p = foot_p.copy()
        f_des = np.zeros((4, 3))
        if act == (1.0, 1.0):
            f_des[:, 2] = MG / 4
        else:
            stance = 0 if act[0] else 1
            swing_p[1 - stance] += [0.05, 0.0, 0.04]
            f_des[2 * stance:2 * stance + 2, 2] = MG / 2
        off = 1.0 if moving else 0.0
        refs.append(dict(
            com_pos=P["com"] + off * np.array([0.01, -0.005, -0.01]),
            com_vel=np.zeros(3), com_acc=np.zeros(3),
            base_R=np.eye(3) if moving else P["base_R"],
            base_angvel=np.zeros(3), base_angacc=np.zeros(3), posture_q=np.asarray(q_stand[7:]),
            contact_pos=foot_p, contact_R=foot_R, swing_pos=swing_p,
            swing_vel=np.zeros((2, 3)), swing_acc=np.zeros((2, 3)), swing_R=foot_R,
            f_des=f_des, contact_active=np.array(act), angmom_L=np.zeros(3),
            angmom_Ldot=np.zeros(3), hand_pos=P["hands"] + off * 0.02,
            torso_R=P["torso_R"], posture_legs_scale=np.array(0.5),
        ))
    return q, v, {k: np.stack([r[k] for r in refs]) for k in refs[0]}


STILL = slice(len(PATTERNS), None)  # the rows the solves are compared on


def _jax_references(g1, idx, gains, q, v, refs):
    """Every JAX reference of the module, one jitted function run on each
    instance (a vmap of it compiles ~20 s longer), with the fast assembly."""
    fast_qp = functools.partial(jstk.build_qp, fast=True)
    levels = []

    def one(q, v, r):
        r = JRefs(**r)
        H, g, C, l, u, (M, h, Jc_T), (A, b, w, lv) = fast_qp(g1, idx, gains, q, v, r, 0.001,
                                                               with_blocks=True)
        levels.append(lv)  # a numpy row tag, static: taken while tracing
        out = dict(blocks=dict(H=H, g=g, C=C, l=l, u=u, M=M, h=h, Jc_T=Jc_T, A=A, b=b, w=w))
        X = jrb.fk(g1, q)
        out["L"] = jstk.angular_momentum(g1, q, v, X)
        out["A_G"] = jstk.centroidal_momentum_matrix(g1, q, X)
        for name, cfg in JAX_CONFIGS.items():
            cfg = cfg._replace(fast_stack=True)
            out[name + "_sol"] = jsol.solve(g1, idx, cfg, gains, q, v, r)._asdict()
        return out

    gj, gji, admm = pallas_lin.gj_solve, pallas_lin.gj_inverse, pallas_lin.admm_iterate
    with mock.patch.object(pallas_lin, "gj_solve", lambda K, b: gj(K, b, interpret=True)), \
            mock.patch.object(pallas_lin, "gj_inverse", lambda K: gji(K, interpret=True)), \
            mock.patch.object(pallas_lin, "admm_iterate",
                              lambda *a, **kw: admm(*a, **kw, interpret=True)), \
            mock.patch.object(jihqp, "build_qp", fast_qp):
        f = jax.jit(one)
        outs = [f(jnp.asarray(q[i]), jnp.asarray(v[i]), {k: jnp.asarray(x[i]) for k, x in refs.items()})
                for i in range(len(q))]
    out = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)
    out["levels"] = levels[0]
    return out


@pytest.fixture(scope="module")
def case(g1, q_stand):
    jidx = jstk.StackIndices.from_model(g1)
    jgains = jdefault_gains(jnp.float64)._replace(w_posture_legs=jnp.asarray(0.7))
    q, v, refs = _inputs(g1, q_stand, jidx)
    tm = trb.load_robot("g1_23dof", device=CPU, dtype=F64)
    ref = _jax_references(g1, jidx, jgains, q, v, refs)
    return dict(
        ref=ref, model=tm, idx=tstk.StackIndices.from_model(tm),
        gains=convert.wbid_gains({k: np.asarray(x) for k, x in jgains._asdict().items()},
                                 device=CPU, dtype=F64),
        refs=convert.wbid_references(refs, device=CPU, dtype=F64),
        q=torch.tensor(q), v=torch.tensor(v),
    )


def _build(case, fast, with_blocks=False, refs=None):
    return tstk.build_qp(case["model"], case["idx"], case["gains"], case["q"], case["v"],
                         refs or case["refs"], 0.001, fast=fast, with_blocks=with_blocks)


@pytest.mark.parametrize("variant", trb.VARIANTS)
def test_leg_joints_from_the_tree(variant):
    """The legs derived from the tree are the joints the JAX package picks by
    name (hip / knee / ankle) on every bundled variant; the postural task
    takes the rest."""
    tm = trb.load_robot(variant, device=CPU, dtype=F64)
    by_name = tuple(j for j, n in enumerate(tm.joint_names)
                    if any(k in n for k in ("hip", "knee", "ankle")))
    assert tstk.leg_joints(tm) == by_name
    if "left_foot_point_contact" in tm.frame_names:
        idx = tstk.StackIndices.from_model(tm)
        assert idx.legs == by_name and len(idx.legs) == 12
        assert set(idx.posture) == set(range(tm.nj)) - set(by_name)
        assert [tm.joint_names[j] for j in idx.knees] == ["left_knee_joint", "right_knee_joint"]
        assert idx.knee_mask.tolist() == ["knee" in n for n in tm.joint_names]


def test_stack_indices_match_jax(case, g1):
    jidx = jstk.StackIndices.from_model(g1)
    idx = case["idx"]
    assert (idx.contacts, idx.feet, idx.pelvis, idx.hands, idx.torso) == tuple(jidx)
    assert tstk.CONTACT_FOOT == (0, 0, 1, 1) and idx.contact_foot.tolist() == [0, 0, 1, 1]


@pytest.mark.parametrize("path", ["default", "fast"])
def test_build_qp_matches_jax(case, path):
    H, g, C, l, u, (M, h, Jc_T), (A, b, w, levels) = _build(case, path == "fast",
                                                            with_blocks=True)
    ref = case["ref"]["blocks"]
    for name, got in zip(BLOCKS + tuple("Abw"), (H, g, C, l, u, M, h, Jc_T, A, b, w)):
        close(got, ref[name], RTOL_QP, f"build_qp {path} {name}")
    np.testing.assert_array_equal(levels, case["ref"]["levels"])
    assert H.shape == (6, 41, 41) and C.shape == (6, 80, 41)


def test_fast_path_equals_default(case):
    """The serving path's assembly builds the same QP as the default one,
    without and with the optional tasks."""
    bare = case["refs"]._replace(hand_pos=None, torso_R=None, posture_legs_scale=None)
    for refs in (case["refs"], bare):
        slow, fast = _build(case, False, refs=refs), _build(case, True, refs=refs)
        for name, a, b in zip("HgClu", slow[:5], fast[:5]):
            close(b, a, 1e-12, f"fast vs default {name}")
        for name, a, b in zip(("M", "h", "Jc_T"), slow[5], fast[5]):
            close(b, a, 1e-12, f"fast vs default {name}")


def test_momentum_matches_jax(case):
    tm, q, v = case["model"], case["q"], case["v"]
    X = trb.fk(tm, q)
    L = tstk.angular_momentum(tm, q, v, X)
    A_G = tstk.centroidal_momentum_matrix(tm, q, X)
    close(L, case["ref"]["L"], 1e-12, "angular_momentum")
    close(A_G, case["ref"]["A_G"], 1e-12, "centroidal_momentum_matrix")
    close((A_G @ v[..., None])[..., 0], L, 1e-12, "A_G v vs L")


def _port_solve(case, name):
    cfg = convert.wbid_config(JAX_CONFIGS[name]._asdict())
    return tsol.solve(case["model"], case["idx"], cfg, case["gains"], case["q"], case["v"],
                      case["refs"])


def _compare(sol, ref, atol, label, rows=STILL, keys=SOLUTION):
    errs = {}
    for key in keys:
        got, want = getattr(sol, key).numpy()[rows], ref[key][rows]
        errs[key] = np.abs(got - want).reshape(len(got), -1).max(axis=1)
        print(f"{label} {key}: max abs err {errs[key].max():.2e}, by instance {errs[key]}")
    for key, err in errs.items():
        assert err.max() <= atol, (label, key, err)


def test_solve_matches_jax(case):
    cuda_lin.reset_launch_counts()
    sol = _port_solve(case, "default")
    assert all(n == 0 for n in cuda_lin.launch_counts().values())  # CPU: plain versions
    _compare(sol, case["ref"]["default_sol"], ATOL_SOL, "solve default")


def test_solve_matches_jax_strict(case):
    """The strict hierarchy. Each level's QP pins the earlier levels' rows
    with weights PIN_RATIO = 1e3 times theirs, a lexicographic order to
    ~1 / PIN_RATIO, and is solved by ADMM and an active-set polish; where the
    levels compete, a change of rounding alone can move the solution within
    that band (the JAX package's left-swing solve here, vmapped instead of
    jitted per instance, lands 1.1 rad/s^2 of 390 away). Per instance, as
    the references are made, the packages agree to 6.2e-7 on qddot, forces
    and torques. pri_res is the largest residual of the three levels' QPs,
    intermediate ones included: in double support the port's first level
    leaves 7.4e-4 where the JAX package's leaves 4e-13, with the same final
    solution; with a foot swinging both leave 0.18 (the cascade's polish
    does not hold every row there). So: qddot, forces, torques and the base
    residual within ATOL_SOL; pri_res no higher than 1.01 times the JAX
    package's largest."""
    cuda_lin.reset_launch_counts()
    sol = _port_solve(case, "strict")
    assert all(n == 0 for n in cuda_lin.launch_counts().values())
    ref = case["ref"]["strict_sol"]
    pri = sol.pri_res[STILL].numpy()
    print(f"solve strict pri_res: port {pri}, JAX {ref['pri_res'][STILL]}")
    assert pri.max() <= 1.01 * ref["pri_res"][STILL].max()
    _compare(sol, ref, ATOL_SOL, "solve strict", keys=SOLUTION[:4])


def test_solve_matches_jax_serving(case):
    """The serving configuration; its polish solves the 80-row Schur system
    with kernel B3's plain version (unpivoted Gauss-Jordan), which also
    agrees with LAPACK's pivoted solve there."""
    ref = case["ref"]["serving_sol"]
    cuda_lin.reset_launch_counts()
    sol = _port_solve(case, "serving")
    assert all(n == 0 for n in cuda_lin.launch_counts().values())
    _compare(sol, ref, ATOL_SOL, "solve serving")
    with mock.patch.object(cuda_lin, "gj_solve", lambda K, b: torch.linalg.solve(K, b)):
        lapack = _port_solve(case, "serving")
    err = float((lapack.forces - sol.forces)[STILL].abs().max())
    print(f"solve serving: B3 plain version vs LAPACK, max abs force err {err:.2e}")
    assert err <= ATOL_SOL


def test_solve_invariants(case):
    """Double support carries the weight, a swinging foot carries nothing,
    the torques stay in their limits, the base rows hold."""
    sol = _port_solve(case, "default")
    f = sol.forces[STILL]
    np.testing.assert_allclose(float(f[0, :, 2].sum()), MG, rtol=0.05)
    assert float(f[1, :2].abs().max()) < 1e-3 and float(f[2, 2:].abs().max()) < 1e-3
    assert torch.all(sol.tau.abs() <= case["model"].tau_max + 1e-9)
    assert float(sol.base_wrench_res.abs().max()) < 1e-4
    assert float(sol.pri_res.max()) < 0.05


def test_solver_module(case):
    """WBIDSolver keeps the model, the stack's constants and the gains as
    buffers and calls solve(); moved to float32 it still solves."""
    cfg = tsol.WBIDConfig()
    module = tsol.WBIDSolver(cfg, case["model"], case["gains"])
    names = {n for n, _ in module.named_buffers()}
    assert {"model_mass", "model_ancestor", "idx_cone_T0", "gain_w_com"} <= names
    got = module(case["q"], case["v"], case["refs"])
    want = tsol.solve(case["model"], case["idx"], cfg, case["gains"], case["q"], case["v"],
                      case["refs"])
    assert torch.equal(got.forces, want.forces) and torch.equal(got.tau, want.tau)
    module.to(torch.float32)
    assert module.model.mass.dtype == torch.float32 and module.idx.cone_T0.dtype == torch.float32
    refs32 = type(case["refs"])(*(None if t is None else t.float() for t in case["refs"]))
    sol32 = module(case["q"].float(), case["v"].float(), refs32)
    assert torch.isfinite(sol32.tau).all()
    np.testing.assert_allclose(sol32.forces.numpy(), want.forces.numpy(), atol=1.0)


def test_convert_config():
    cfg = convert.wbid_config(JAX_CONFIGS["serving"]._asdict())
    assert cfg == tsol.WBIDConfig(qp=tsol.WBIDConfig().qp._replace(polish_kernel=True),
                                  fast_stack=True)
    with pytest.raises(TypeError):
        convert.wbid_config({"no_such_field": 1})
