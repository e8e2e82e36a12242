"""The JAX package's WBID tick at float32 on the CPU, on the states that
chip_smoke.py's phases 5 and 6 drive the PyTorch port through: the largest
swing-contact force and base-wrench residual it gives there. chip_smoke.py
holds the port to twice these (SWING_F_MAX_N, BASE_RES_MAX).

    JAX_PLATFORMS=cpu python tools/wbid_invariant_bounds.py

* serving: 40 data-dependent B = 1 ticks from the standing pose in the
  serving configuration (``polish_kernel``, ``fast_stack``; the Pallas
  kernels in interpret mode), 20 in double support and 20 with the left foot
  swinging, v += qddot dt, q = integrate_q(q, v, dt);
* batched: the 2048 instances of ``chip_smoke.wbid_batch_spec`` in the
  default WBIDConfig.

Prints one JSON line with the maxima of each, and beside them the PyTorch
port's own maxima at float32 on the CPU for the same states (``port_cpu``,
its kernels' plain versions), for comparison.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from unittest import mock

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from g1_locomotion_tpu.engine.state import q_init_standing  # noqa: E402
from g1_locomotion_tpu.models import dynamics as dyn  # noqa: E402
from g1_locomotion_tpu.models import robot as rb  # noqa: E402
from g1_locomotion_tpu.ops import pallas_lin  # noqa: E402
from g1_locomotion_tpu.wbid import solver as ws  # noqa: E402
from g1_locomotion_tpu.wbid.stack import StackIndices  # noqa: E402
from g1_locomotion_tpu.wbid.tasks import WBIDReferences, default_gains  # noqa: E402

F32 = jnp.float32


def refs_at(model, idx, q, active, dcom):
    """chip_smoke.wbid_refs for one instance."""
    X = rb.fk(model, q)
    feet = [rb.frame_pose(model, X, f) for f in idx.feet]
    foot_p = jnp.stack([P.p for P in feet])
    foot_R = jnp.stack([P.R for P in feet])
    on = jnp.repeat(active, 2)
    fz = jnp.sum(model.mass) * dyn.GRAVITY * on / jnp.sum(on)
    z3 = jnp.zeros(3, F32)
    return WBIDReferences(
        com_pos=rb.com_position(model, X) + dcom, com_vel=z3, com_acc=z3, base_R=X.R[0],
        base_angvel=z3, base_angacc=z3, posture_q=q[7:], contact_pos=foot_p, contact_R=foot_R,
        swing_pos=foot_p + (1 - active)[:, None] * jnp.asarray(cs.SWING_TARGET, F32),
        swing_vel=jnp.zeros((2, 3), F32), swing_acc=jnp.zeros((2, 3), F32), swing_R=foot_R,
        f_des=jnp.stack([jnp.zeros_like(fz), jnp.zeros_like(fz), fz], axis=-1),
        contact_active=active, angmom_L=z3, angmom_Ldot=z3,
    )


def maxima(model, sol, active):
    on = np.repeat(np.asarray(active), 2, axis=-1) > 0.5
    forces = np.asarray(sol.forces).reshape(-1, 4, 3)
    double = np.asarray(active).reshape(-1, 2).sum(axis=1) > 1.5
    mg = float(jnp.sum(model.mass)) * dyn.GRAVITY
    fz = forces[..., 2].sum(axis=1)
    return {
        "f_swing_N": float(np.abs(np.where(on.reshape(-1, 4)[..., None], 0.0, forces)).max()),
        "base_res": float(np.abs(np.asarray(sol.base_wrench_res)).max()),
        "fz_dev_N": float(np.abs(fz[double] - mg).max()) if double.any() else 0.0,
        "pri_res": float(np.asarray(sol.pri_res).max()),
    }


def merge(a, b):
    return {k: max(a[k], b[k]) for k in a}


def port_maxima():
    """chip_smoke.py's phases 5 and 6 through the port on the CPU, float32."""
    import torch

    from g1_locomotion_tpu_torch.models.robot import load_robot as load_port
    from g1_locomotion_tpu_torch.wbid.solver import WBIDSolver
    from g1_locomotion_tpu_torch.wbid.tasks import default_gains as port_gains

    cpu, f32 = torch.device("cpu"), torch.float32
    robot = load_port("g1_23dof", device=cpu, dtype=f32)
    gains = port_gains(device=cpu, dtype=f32)
    serving_cfg, batched_cfg = cs.wbid_configs()
    srv, bat = WBIDSolver(serving_cfg, robot, gains), WBIDSolver(batched_cfg, robot, gains)
    worst, _ = cs.serving_chain(srv, srv.model, srv.idx, cpu, f32)
    q, v, refs = cs.wbid_batch(bat.model, bat.idx, cs.B_WBID, cpu, f32)
    batched = cs.wbid_violations(robot, bat(q, v, refs), refs.contact_active, phase=6)
    return {"serving_chain": worst["max"], "batched": batched["max"]}


def main():
    model = rb.load_robot("g1_23dof", dtype=F32)
    idx = StackIndices.from_model(model)
    gains = default_gains(F32)
    base = ws.WBIDConfig()
    serving = base._replace(qp=base.qp._replace(polish_kernel=True), fast_stack=True)

    gj, gji, admm = pallas_lin.gj_solve, pallas_lin.gj_inverse, pallas_lin.admm_iterate
    with mock.patch.object(pallas_lin, "gj_solve", lambda K, b: gj(K, b, interpret=True)), \
            mock.patch.object(pallas_lin, "gj_inverse", lambda K: gji(K, interpret=True)), \
            mock.patch.object(pallas_lin, "admm_iterate",
                              lambda *a, **kw: admm(*a, **kw, interpret=True)):
        tick = jax.jit(lambda q, v, r: ws.solve(model, idx, serving, gains, q, v, r))
        q = q_init_standing(model, F32)
        v = jnp.zeros(model.nv, F32)
        stances = [jnp.asarray([1.0, 1.0], F32), jnp.asarray([0.0, 1.0], F32)]
        refs = [refs_at(model, idx, q, a, jnp.zeros(3, F32)) for a in stances]
        worst = None
        for t in range(cs.WBID_TICKS):
            k = 0 if t < cs.WBID_STANCE_TICKS else 1
            sol = tick(q, v, refs[k])
            m = maxima(model, sol, stances[k])
            worst = m if worst is None else merge(worst, m)
            v = v + sol.qddot * cs.WBID_DT
            q = rb.integrate_q(model, q, v, cs.WBID_DT)

    spec = cs.wbid_batch_spec(cs.B_WBID, model.nj)
    qs = jnp.tile(q_init_standing(model, F32), (cs.B_WBID, 1))
    qs = qs.at[:, 7:].add(jnp.asarray(spec["dqj"], F32))
    active = jnp.asarray([[1.0, 1.0], [0.0, 1.0], [1.0, 0.0]], F32)[spec["pattern"]]
    batch_refs = jax.vmap(lambda q, a, d: refs_at(model, idx, q, a, d))(
        qs, active, jnp.asarray(spec["dcom"], F32))
    sols = jax.jit(jax.vmap(lambda q, v, r: ws.solve(model, idx, base, gains, q, v, r)))(
        qs, jnp.asarray(spec["v"], F32), batch_refs)
    batched = maxima(model, sols, active)
    print(json.dumps({"platform": jax.devices()[0].platform, "dtype": "float32",
                      "serving_chain": worst, "batched": batched, "port_cpu": port_maxima()}))


if __name__ == "__main__":
    main()
