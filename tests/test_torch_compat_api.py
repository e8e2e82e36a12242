"""The reference-compatible surfaces of the PyTorch port (mpc/api.MPC and
msgs) against the JAX package's, on the CPU at float64.

* ``MPC``: the standing case of ``tests/test_compat_api.py:10-49`` through
  both classes: u_opt0 and x_opt of the first update and of the
  warm-started second within 1e-9 relative (measured in CHANGES.md), and
  that test's own checks on the port.
* ``msgs``: the State round trip, batched too; ``srbd_current_from_engine``
  of a perturbed standing state against the JAX package's, 1e-12.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu import msgs as jmsgs
from g1_locomotion_tpu.engine.state import q_init_standing as jq_init
from g1_locomotion_tpu.models import robot as jrb
from g1_locomotion_tpu.mpc.api import MPC as JMPC
from g1_locomotion_tpu_torch import msgs
from g1_locomotion_tpu_torch.models import robot as trb
from g1_locomotion_tpu_torch.mpc.api import MPC

CPU = torch.device("cpu")
F64 = torch.float64
RTOL = 1e-9


def _standing(M):
    """tests/test_compat_api.py's setup (run_simulation.py:70-106): standing,
    all contacts active for the whole horizon."""
    M.x0[0:3] = 0.0
    M.x0[3:6] = np.array([[5.26790425e-02], [7.44339342e-05], [5.97983255e-01]])
    M.x0[6:12] = 0.0
    M.x0[12] = M.g
    M.x_ref_hor[:, :] = 0.0
    M.x_ref_hor[0, :] = M.x0[:, 0]
    M.x_ref_hor[0:, 3:6] = [5.26790425e-02, 7.44339342e-05, 5.97983255e-01]
    M.x_ref_hor[0:, -1] = M.g
    feet = np.array([[-0.05, 0.12, 0.0], [0.12, 0.12, 0.0], [-0.05, -0.12, 0.0],
                     [0.12, -0.12, 0.0]])
    c_horizon = [feet.reshape(-1) for _ in range(M.HORIZON_LENGTH)]
    contact_horizon = [np.array([1, 1, 1, 1]) for _ in range(M.HORIZON_LENGTH)]
    return contact_horizon, c_horizon, M.x_ref_hor[:, 3:6].copy()


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def test_mpc_class_matches_jax():
    ref, got = JMPC(dt=0.04, dtype=jnp.float64), MPC(dt=0.04, dtype=F64, device=CPU)
    assert got.HORIZON_LENGTH == ref.HORIZON_LENGTH == 10 and got.g == ref.g == -9.80665
    assert got.dt == ref.dt and got.x0.shape == ref.x0.shape
    assert got.x_ref_hor.shape == ref.x_ref_hor.shape
    ref.init_matrices()
    got.init_matrices()
    args_ref, args = _standing(ref), _standing(got)
    for call in range(2):  # the second call is warm-started from the first
        ru, rx = ref.update(*args_ref, x_current=ref.x0, one_rollout=True)
        u, x = got.update(*args, x_current=got.x0, one_rollout=True)
        assert isinstance(u, np.ndarray) and u.shape == (12,) and x.shape == (11, 13)
        print(f"update {call}: u_opt0 max rel err {_rel(u, np.asarray(ru)):.3e}, x_opt "
              f"{_rel(x, np.asarray(rx)):.3e} (<= {RTOL})")
        assert _rel(u, np.asarray(ru)) <= RTOL and _rel(x, np.asarray(rx)) <= RTOL
        if call == 0:
            u_first = u
    # tests/test_compat_api.py's checks, on the port.
    np.testing.assert_allclose(u_first[2::3].sum(), 34.1329 * 9.80665, rtol=5e-3)
    np.testing.assert_allclose(x[1, 3:6], got.x0[3:6, 0], atol=5e-3)
    np.testing.assert_allclose(u, u_first, atol=1e-3)
    with pytest.raises(NotImplementedError):
        got.update(*args, one_rollout=False)


def test_mpc_class_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MPC()


def test_msgs_roundtrip():
    x = torch.arange(13.0, dtype=F64)
    st = msgs.State.from_vector(x)
    assert torch.equal(st.to_vector(), x)
    ref = jmsgs.State.from_vector(jnp.arange(13.0))
    for f in dataclasses.fields(jmsgs.State):
        np.testing.assert_array_equal(getattr(st, f.name).numpy(), np.asarray(getattr(ref, f.name)))
    xb = torch.randn((4, 13), generator=torch.Generator().manual_seed(0), dtype=F64)
    assert torch.equal(msgs.State.from_vector(xb).to_vector(), xb)
    assert msgs.CONTACT_NAMES == jmsgs.CONTACT_NAMES
    for name in ("State", "ContactPoint", "SRBDState", "FeetReference"):
        assert ([f.name for f in dataclasses.fields(getattr(msgs, name))]
                == [f.name for f in dataclasses.fields(getattr(jmsgs, name))]), name


def test_srbd_current_matches_jax():
    jm = jrb.load_robot("g1_23dof", dtype=jnp.float64)
    tm = trb.load_robot("g1_23dof", device=CPU, dtype=F64)
    rng = np.random.default_rng(4)
    q = np.asarray(jq_init(jm, jnp.float64)).copy()
    q[7:] += rng.uniform(-0.05, 0.05, tm.nj)
    v = rng.uniform(-0.2, 0.2, tm.nv)
    forces = rng.uniform(0.0, 100.0, (4, 3))
    ref = jmsgs.srbd_current_from_engine(jm, jnp.asarray(q), jnp.asarray(v), jnp.asarray(forces))
    got = msgs.srbd_current_from_engine(tm, torch.tensor(q)[None], torch.tensor(v)[None],
                                        torch.tensor(forces).reshape(1, 12))
    assert got.states_horizon.shape == (1, 1, 13)
    for f in dataclasses.fields(jmsgs.SRBDState):
        g, r = getattr(got, f.name)[0].numpy(), np.asarray(getattr(ref, f.name))
        assert g.shape == r.shape, f.name
        print(f"{f.name}: max abs err {np.abs(g - r).max():.3e} (<= 1e-12 + 1e-12 |ref|)")
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-12, err_msg=f.name)
    assert float(got.states_horizon[0, 0, 12]) == pytest.approx(-9.80665)
