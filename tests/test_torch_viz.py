"""utils/viz.py and utils/replay.py of the PyTorch port, on the CPU.

* ``skeleton_segments`` and ``contact_points`` against the JAX package's at
  configurations the JAX MuJoCo loop recorded (tests/torch_mujoco_trace.npz),
  within 1e-12 m (both are FK at float64; measured maxima in CHANGES.md).
* ``save_log`` / ``load_log`` round-trip a port ``TickLog`` exactly;
  ``plot_rollout`` and ``render_replay`` write their files from the log of a
  tiny port rollout with ``log_q`` (tests/test_replay.py's configuration).
"""

from pathlib import Path

import numpy as np
import torch

from g1_locomotion_tpu.utils import replay as jreplay
from g1_locomotion_tpu.wbid.stack import StackIndices as JStackIndices
from g1_locomotion_tpu_torch.engine import tick as eng
from g1_locomotion_tpu_torch.models.robot import load_robot
from g1_locomotion_tpu_torch.mpc.solver import MPCConfig
from g1_locomotion_tpu_torch.ops.qp import QPConfig
from g1_locomotion_tpu_torch.utils import replay, viz
from g1_locomotion_tpu_torch.wbid.solver import WBIDConfig
from g1_locomotion_tpu_torch.wbid.stack import StackIndices

CPU, F64 = torch.device("cpu"), torch.float64
TRACE = Path(__file__).parent / "torch_mujoco_trace.npz"


def test_skeleton_and_contacts_match_jax(g1):
    model = load_robot("g1_23dof", device=CPU, dtype=F64)
    idx, jidx = StackIndices.from_model(model), JStackIndices.from_model(g1)
    qpos = np.load(TRACE)["qpos"]
    worst = 0.0
    for q in qpos[[0, 100, 199]]:
        segs, jsegs = replay.skeleton_segments(model, q), jreplay.skeleton_segments(g1, q)
        cp, jcp = replay.contact_points(model, idx, q), jreplay.contact_points(g1, jidx, q)
        assert segs.shape == (model.nb - 1, 2, 3) and cp.shape == (4, 3)
        worst = max(worst, np.abs(segs - jsegs).max(), np.abs(cp - jcp).max())
    print(f"skeleton and contact points: max |d| {worst:.2e} m")
    assert worst <= 1e-12


def _tiny_log():
    cfg = eng.EngineConfig(
        mpc=MPCConfig(horizon=4, qp=QPConfig(iters=12, scaling_iters=0, rho=1.0,
                                             rho_segments=1, polish=False)),
        wbid=WBIDConfig(qp=QPConfig(iters=10, scaling_iters=0, rho=0.1, rho_segments=1,
                                    polish=False)),
        ticks_per_mpc=4, log_q=True)
    model = load_robot("g1_23dof", device=CPU, dtype=F64)
    params = eng.default_scenario(device=CPU, dtype=F64)
    params = params._replace(gait=params.gait._replace(n_steps=torch.tensor(0.0, dtype=F64)))
    _, log = eng.ControlLoop(model, cfg).rollout(eng.init_state(model, cfg, 1, F64), params, 2)
    return model, log


def test_log_plot_and_replay(tmp_path):
    model, log = _tiny_log()
    path = tmp_path / "log.npz"
    viz.save_log(str(path), log)
    saved = viz.load_log(str(path))
    assert set(saved) == set(log._fields)
    for name, leaf in zip(log._fields, log):
        assert np.array_equal(saved[name], leaf.numpy())
    plot = tmp_path / "plot.png"
    viz.plot_rollout(saved, str(plot))
    assert plot.stat().st_size > 10_000 and (tmp_path / "plot_plan.png").exists()

    qs = saved["q"].reshape(-1, model.nq)
    assert qs.shape == (8, model.nq)
    np.testing.assert_allclose(qs[0, 3], 1.0, atol=0.1)  # a sane wxyz quaternion
    files = replay.render_replay(model, qs, forces=saved["forces"].reshape(-1, 4, 3),
                                 coms=saved["com"].reshape(-1, 3), out_dir=str(tmp_path / "rp"),
                                 stride=4, gif=True)
    assert len([f for f in files if f.endswith(".png")]) == 2
    assert len([f for f in files if f.endswith(".gif")]) == 1
    assert all(Path(f).stat().st_size > 1000 for f in files)
