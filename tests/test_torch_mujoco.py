"""The MuJoCo closed loop of the PyTorch port against the JAX package, on the
CPU at float64.

* ``models/mjcf.export_mjcf``: byte-equal to the reference's for the four
  variants, with and without the floor and the joint limits; the MJCF
  loads in MuJoCo.
* ``utils/pd.pd_torques``: equal to the reference's, the clip included.
* The MuJoCo scenarios and config of ``engine/tick.py``: field by field
  within 1e-12 of each field's scale, the config equal.
* ``engine/mujoco_bridge``: the frame conversion of ``read_v`` on a tilted,
  yawed base within 1e-15; the port's ``MujocoLoop`` settles to the JAX
  loop's settled state within 1e-12; the bridge's controller replays
  ``tests/torch_mujoco_trace.npz`` (the JAX package's ``MujocoLoop`` in
  ``test_standing_balance_in_mujoco``'s configuration, recorded by
  ``tools/record_mujoco_trace.py``) tick by tick: tau within 5e-2 N m, the
  contact normal forces within 0.5 N, the CoM within 1e-4 m (the golden's
  tolerances: on some ticks the WBID QP's polish takes another acceptance
  decision than the jitted JAX tick, which moves tau by ~1e-2 N m; on the
  other ticks the two agree to ~1e-12, and at least three quarters of the
  ticks must); and an 80-tick closed loop of the port's ``MujocoLoop``
  follows the recorded MuJoCo states within 1e-4 (m, rad, m/s, rad/s).
Measured maxima in CHANGES.md. The replay and the closed loop take ~15 s
each.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.core import rotations as jrot
from g1_locomotion_tpu.engine import tick as jeng
from g1_locomotion_tpu.models.mjcf import export_mjcf as jexport
from g1_locomotion_tpu.models.urdf import spec_from_dict as jspec_from_dict
from g1_locomotion_tpu.utils import pd as jpd
from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.engine import mujoco_bridge as bridge
from g1_locomotion_tpu_torch.engine import tick as eng
from g1_locomotion_tpu_torch.models import robot as rb
from g1_locomotion_tpu_torch.models.mjcf import export_mjcf
from g1_locomotion_tpu_torch.models.urdf import spec_from_dict
from g1_locomotion_tpu_torch.utils import pd

CPU, F64 = torch.device("cpu"), torch.float64
TRACE = Path(__file__).parent / "torch_mujoco_trace.npz"
REPLAY_TICKS = 80
TOL = {"tau": 5e-2, "fz": 0.5, "com": 1e-4}  # tests/test_golden.py's
CLOSED_LOOP_TOL = 1e-4


def _spec_pair(variant):
    import json

    text = (rb.ASSET_DIR / f"{variant}.json").read_text()
    return spec_from_dict(json.loads(text)), jspec_from_dict(json.loads(text))


@pytest.mark.parametrize("variant", rb.VARIANTS)
def test_export_mjcf_byte_equal(variant):
    port, ref = _spec_pair(variant)
    for with_floor in (False, True):
        for with_limits in (None, False, True):
            kw = dict(with_floor=with_floor, with_limits=with_limits)
            assert export_mjcf(port, **kw) == jexport(ref, **kw), kw
    mujoco = pytest.importorskip("mujoco")
    m = mujoco.MjModel.from_xml_string(export_mjcf(port, with_floor=True))
    assert m.nq == 7 + len([b for b in port.bodies if b.joint is not None])


def test_pd_torques_match_jax(rng):
    q_des, q, dq = (rng.normal(size=23) for _ in range(3))
    kp, kd = rng.uniform(50, 400, 23), rng.uniform(1, 20, 23)
    t = lambda x: torch.tensor(x, dtype=F64)  # noqa: E731
    for tau_max in (None, 30.0, rng.uniform(20, 90, 23)):
        want = np.asarray(jpd.pd_torques(jpd.PDGains(jnp.asarray(kp), jnp.asarray(kd)),
                                         q_des, q, dq, tau_max=tau_max))
        limit = t(tau_max) if isinstance(tau_max, np.ndarray) else tau_max
        got = pd.pd_torques(pd.PDGains(t(kp), t(kd)), t(q_des), t(q), t(dq), tau_max=limit)
        np.testing.assert_array_equal(got.numpy(), want)
    # tests/test_compat_api.py:72's case: 100 N m clipped to 50.
    tau = pd.pd_torques(pd.PDGains(torch.tensor(100.0), torch.tensor(10.0)), torch.ones(3),
                        torch.zeros(3), torch.zeros(3), tau_max=50.0)
    assert torch.equal(tau, torch.full((3,), 50.0))
    g = pd.default_gains(device=CPU, dtype=F64)
    jg = jpd.default_gains(jnp.float64)
    assert float(g.kp) == float(jg.kp) and float(g.kd) == float(jg.kd)


def _leaves(tree):
    if hasattr(tree, "_fields"):
        return [x for f in tree for x in _leaves(f)]
    return [tree]


@pytest.mark.parametrize("name", ["mujoco_walking_scenario", "mujoco_nominal_scenario"])
def test_mujoco_scenarios_match_jax(name):
    kw = dict(n_steps=6.0, v_cmd=(0.1, 0.0))
    want = convert.scenario_params(getattr(jeng, name)(jnp.float64, **kw), device=CPU, dtype=F64)
    got = getattr(eng, name)(device=CPU, dtype=F64, **kw)
    for g, w in zip(_leaves(got), _leaves(want)):
        scale = max(float(np.abs(w.numpy()[np.isfinite(w.numpy())]).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-12 * scale)
    assert eng.mujoco_nominal_config() == convert.engine_config(
        jeng.mujoco_nominal_config()._asdict())


def test_read_v_frame_conversion():
    rng = np.random.default_rng(3)
    rpy = np.array([0.2, -0.15, 2.4])  # tilted and yawed
    quat = np.asarray(jrot.rpy_to_quat(jnp.asarray(rpy)))
    qpos = np.concatenate([[0.1, -0.2, 0.7], quat, rng.normal(size=23)])
    qvel = rng.normal(size=29)
    want = qvel.copy()
    want[:3] = np.asarray(jrot.quat_to_matrix(jnp.asarray(qpos[3:7]))).T @ qvel[:3]
    got = bridge.base_local_velocity(qpos, qvel)
    assert np.abs(got - want).max() <= 1e-15
    assert np.array_equal(got[3:], qvel[3:])


@pytest.fixture(scope="module")
def trace():
    return dict(np.load(TRACE))


@pytest.fixture(scope="module")
def model():
    return rb.load_robot("g1_23dof", device=CPU, dtype=F64)


def test_trace_replay_matches_jax(trace, model):
    ctrl = bridge.BridgeController(model, params=eng.mujoco_standing_scenario(device=CPU,
                                                                               dtype=F64))
    ctrl.reset(trace["qpos"][0], trace["qvel"][0])
    err = {k: [] for k in TOL}
    for t in range(REPLAY_TICKS):
        tau, log = ctrl.step(trace["qpos"][t], trace["qvel"][t])
        err["tau"].append(np.abs(tau - trace["tau"][t]).max())
        err["fz"].append(np.abs(log.forces[0, :, 2].numpy() - trace["fz"][t]).max())
        err["com"].append(np.abs(log.com[0].numpy() - trace["com"][t]).max())
    tau_err = np.array(err["tau"])
    print({k: f"{max(v):.2e}" for k, v in err.items()},
          f"ticks with |dtau| <= 1e-9: {int((tau_err <= 1e-9).sum())} of {REPLAY_TICKS}")
    for k, tol in TOL.items():
        assert max(err[k]) <= tol, k
    assert (tau_err <= 1e-9).sum() >= 0.75 * REPLAY_TICKS
    stats = ctrl.stats.export()
    assert '"mpc_solve"' in stats and '"wbid_solve"' in stats


def test_settle_and_closed_loop_follow_jax(trace, model):
    pytest.importorskip("mujoco")
    loop = bridge.MujocoLoop(model, params=eng.mujoco_standing_scenario(device=CPU, dtype=F64))
    settle = max(np.abs(loop.mj_data.qpos - trace["qpos"][0]).max(),
                 np.abs(loop.mj_data.qvel - trace["qvel"][0]).max())
    assert settle <= 1e-12
    dev = 0.0
    for t in range(REPLAY_TICKS):
        dev = max(dev, np.abs(loop.mj_data.qpos - trace["qpos"][t]).max(),
                  np.abs(loop.mj_data.qvel - trace["qvel"][t]).max())
        log = loop.run(1)
    dev = max(dev, np.abs(loop.mj_data.qpos - trace["qpos"][REPLAY_TICKS]).max())
    print(f"settled state {settle:.2e}; closed loop, largest |dqpos|, |dqvel| {dev:.2e}")
    assert dev <= CLOSED_LOOP_TOL
    assert np.isfinite(log["tau"]).all() and loop.ctrl.tick == REPLAY_TICKS
