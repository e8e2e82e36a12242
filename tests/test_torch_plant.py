"""engine/plant.py of the PyTorch port against the JAX package, on the CPU at
float64.

Six instances made with numpy from a seed: the standing pose perturbed
(joints by up to 0.05 rad, the base tilted and moved), moving (velocities
~0.1), with torques around the standing load, under the contact patterns of
the gait (double support, left swing, right swing, each twice); the pins sit
a few millimetres off the contact points, so the Baumgarte terms act. The
JAX side is ``jax.vmap(plant.constrained_step)``.

Tolerance: q_next within 1e-10 and v_next within 1e-9 relative to each
array's largest entry (at least 1), each foot's net contact force within
1e-5 N of ~600 N (both sides
solve the same LU system; measured maxima in CHANGES.md; the split of a
foot's force between its heel and toe pins is not determined, see the
test). Also the float32 regularisation:
at float32 the port's KKT relaxation is max(kkt_reg, 1e-5), as the
reference's, so a float32 stand stays finite.
"""

import jax
import numpy as np
import torch

from g1_locomotion_tpu.engine import plant as jplant
from g1_locomotion_tpu.engine.state import q_init_standing as jq_stand
from g1_locomotion_tpu.wbid.stack import StackIndices as JIdx
from g1_locomotion_tpu_torch.engine import plant as tplant
from g1_locomotion_tpu_torch.engine.state import q_init_standing
from g1_locomotion_tpu_torch.models.dynamics import gravity_force
from g1_locomotion_tpu_torch.models.robot import load_robot
from g1_locomotion_tpu_torch.wbid.stack import StackIndices

CPU = torch.device("cpu")
F64 = torch.float64
PATTERNS = ((1, 1, 1, 1), (0, 0, 1, 1), (1, 1, 0, 0))


def _inputs(g1):
    rng = np.random.default_rng(0)
    B = 2 * len(PATTERNS)
    q = np.tile(np.asarray(jq_stand(g1)), (B, 1))
    q[:, 7:] += rng.uniform(-0.05, 0.05, (B, g1.nj))
    q[:, 0:3] += rng.uniform(-0.01, 0.01, (B, 3))
    quat = np.concatenate([np.ones((B, 1)), 0.02 * rng.normal(size=(B, 3))], axis=1)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    v = 0.1 * rng.normal(size=(B, g1.nv))
    tau = rng.uniform(-20.0, 20.0, (B, g1.nj))
    active = np.asarray([PATTERNS[i % len(PATTERNS)] for i in range(B)], dtype=np.float64)
    idx = JIdx.from_model(g1)
    anchors = np.array(jax.vmap(lambda qq: jplant.anchors_from_state(g1, idx, qq))(q))
    anchors += rng.uniform(-0.003, 0.003, anchors.shape)
    return dict(q=q, v=v, tau=tau, active=active, anchors=anchors)


def test_constrained_step_matches_jax(g1):
    inp = _inputs(g1)
    idx = JIdx.from_model(g1)
    cfg = jplant.PlantConfig()
    ref = jax.jit(jax.vmap(lambda q, v, tau, a, an: jplant.constrained_step(
        g1, idx, cfg, q, v, tau, a, an)))(*(inp[k] for k in ("q", "v", "tau", "active",
                                                               "anchors")))
    model = load_robot("g1_23dof", device=CPU, dtype=F64)
    t = {k: torch.tensor(v, dtype=F64) for k, v in inp.items()}
    got = tplant.constrained_step(model, StackIndices.from_model(model), tplant.PlantConfig(),
                                  t["q"], t["v"], t["tau"], t["active"], t["anchors"])
    for name, g, r, tol in zip(("q_next", "v_next"), got[:2], ref[:2], (1e-10, 1e-9)):
        err = float(np.abs(g.numpy() - np.asarray(r)).max() / max(np.abs(np.asarray(r)).max(), 1))
        print(f"{name}: max rel err {err:.2e}")
        assert err <= tol, (name, err)
    # Per foot: the heel / toe pair pins one rigid foot twice, so the force
    # along the line between them is internal (no net force, no moment) and
    # is set by the relaxation alone (a 1e-9 regularisation divides rounding
    # by 1e-9 there): the feet's net forces are what the plant determines.
    f_got, f_ref = got[2].numpy(), np.asarray(ref[2])
    feet_got, feet_ref = f_got.reshape(-1, 2, 2, 3).sum(2), f_ref.reshape(-1, 2, 2, 3).sum(2)
    df = float(np.abs(feet_got - feet_ref).max())
    print(f"net foot forces: max abs err {df:.2e} N (largest {np.abs(feet_ref).max():.1f} N); "
          f"per contact {np.abs(f_got - f_ref).max():.2e} N")
    assert df <= 1e-5
    # Swing contacts carry exactly zero force.
    assert torch.all(got[2][t["active"] < 0.5] == 0)
    # Anchors from the state: the contact points.
    np.testing.assert_allclose(
        tplant.anchors_from_state(model, StackIndices.from_model(model), t["q"]).numpy(),
        np.asarray(jax.vmap(lambda qq: jplant.anchors_from_state(g1, idx, qq))(inp["q"])),
        rtol=0, atol=1e-14)


def test_float32_stand_stays_finite():
    """40 float32 ticks from the standing pose, both feet pinned, the joint
    torques those of gravity: the dtype-dependent regularisation keeps the
    LU regular and every output finite."""
    model = load_robot("g1_23dof", device=CPU, dtype=torch.float32)
    idx = StackIndices.from_model(model)
    q = q_init_standing(model, 2)
    v = q.new_zeros((2, model.nv))
    anchors = tplant.anchors_from_state(model, idx, q)
    active = q.new_ones((2, 4))
    for _ in range(40):
        tau = gravity_force(model, q)[:, 6:]
        q, v, f = tplant.constrained_step(model, idx, tplant.PlantConfig(), q, v, tau, active,
                                          anchors)
    assert torch.isfinite(q).all() and torch.isfinite(v).all() and torch.isfinite(f).all()
