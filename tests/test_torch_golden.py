"""The port's validated walk against the JAX package's golden trajectory,
without JAX.

``walking_config()`` with ``walking_scenario(float64, 8 steps, v_cmd =
(0.1, 0))`` from ``init_state``, B = 1, on the CPU at float64 (no kernel on
this path), against ``tests/goldens/walk_golden.npz`` (numpy reads it):
contact flags equal, CoM within 1e-4 m, joint torques within 5e-2 N m, WBID
contact forces within 0.5 N per tick, the tolerances of
``tests/test_golden.py`` (not widened).

* ``test_golden_prefix``: the first 15 periods (0.6 s: the stand and the
  start of the first double support; about 1.5 minutes of CPU).
* ``test_golden_full`` (``slow``): all 100 periods (4 s, seven steps), the
  golden's full length (about 10 minutes of CPU; its last result is in
  CHANGES.md).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from g1_locomotion_tpu_torch.engine import tick as teng
from g1_locomotion_tpu_torch.models.robot import load_robot

GOLDEN = Path(__file__).parent / "goldens" / "walk_golden.npz"
TICKS = 40
TOL = dict(com=1e-4, tau=5e-2, forces=5e-1)


def _walk(periods: int):
    model = load_robot("g1_23dof", device=torch.device("cpu"), dtype=torch.float64)
    cfg = teng.walking_config()
    loop = teng.ControlLoop(model, cfg)
    state = teng.init_state(model, cfg, 1, torch.float64)
    params = teng.walking_scenario(device=torch.device("cpu"), dtype=torch.float64,
                                   n_steps=8.0, v_cmd=(0.1, 0.0))
    with torch.no_grad():
        _, log = loop.rollout(state, params, periods)
    return log


def _check(periods: int):
    log = _walk(periods)
    n = periods * TICKS
    with np.load(GOLDEN) as z:
        golden = {k: z[k][:n] for k in ("com", "tau", "forces", "contact")}
    got = dict(com=log.com[0].reshape(n, 3), tau=log.tau[0].reshape(n, 23),
               forces=log.forces[0].reshape(n, 4, 3), contact=log.contact[0].reshape(n, 4))
    over = {}
    for name, tol in TOL.items():
        err = np.abs(got[name].numpy() - golden[name]).reshape(n, -1).max(axis=1)
        first = np.flatnonzero(err > tol)
        print(f"{name}: max abs err {err.max():.3e} at tick {int(err.argmax())} (<= {tol}); "
              f"first tick over: {first[0] if first.size else None}")
        if first.size:
            over[name] = (int(first[0]), float(err.max()))
    np.testing.assert_array_equal(got["contact"].numpy(), golden["contact"])
    assert not over, over


def test_golden_prefix():
    _check(15)


@pytest.mark.slow
def test_golden_full():
    _check(100)
