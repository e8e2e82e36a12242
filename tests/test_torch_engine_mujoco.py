"""tests/test_engine_mujoco.py's five closed loops in real MuJoCo, on the
PyTorch port's bridge (CPU, float64; ``slow`` as there): the bars of
``tools/torch_mujoco_bar.py``, which runs the same function on the card
where the ``mujoco`` package is installed. Not slow: the standing bar at
chip_smoke.py's phase-17 depth (200 ticks, ~40 s), the function that phase
runs on the card.
"""

import sys
from pathlib import Path

import pytest
import torch

pytest.importorskip("mujoco")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))


@pytest.mark.slow
@pytest.mark.parametrize("config", ["stand_1s", "walk_6", "quiet_3s", "push", "nominal"])
def test_mujoco_bar(config):
    import torch_mujoco_bar as bar

    res = bar.bar(config, torch.device("cpu"))
    ticks = res.pop("ticks")
    print(config, ticks, {k: v[0] for k, v in res.items()})
    failed = {k: v for k, v in res.items() if not v[2]}
    assert not failed, failed


def test_standing_bar_at_the_chip_check_depth():
    import torch_mujoco_bar as bar

    from g1_locomotion_tpu_torch.engine import tick as eng
    from g1_locomotion_tpu_torch.engine.mujoco_bridge import MujocoLoop
    from g1_locomotion_tpu_torch.models import robot as rb

    cpu = torch.device("cpu")
    model = rb.load_robot("g1_23dof", device=cpu, dtype=torch.float64)
    loop = MujocoLoop(model, params=eng.mujoco_standing_scenario(device=cpu,
                                                                 dtype=torch.float64))
    res = bar.standing_bar(loop, 200)
    print({k: v[0] for k, v in res.items()})
    failed = {k: v for k, v in res.items() if not v[2]}
    assert not failed and loop.ctrl.tick == 200, failed
