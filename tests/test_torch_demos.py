"""api/demos.py and api/cli.py of the PyTorch port, on the CPU at float64.

* ``demo_pod_sweep``'s checkpoint / resume (``tests/test_sweep_resume.py``'s
  check): an interrupted two-chunk sweep resumed from its checkpoint
  reports the statistics of one unchunked run of the same length.
* ``demo_gait_sweep`` at a small batch: finite, every solve's residual
  small.
* The CLI: the sweeps run on the CPU when asked; every other subcommand
  reaches its demo with the reference CLI's arguments (the demo replaced by
  a recorder; the demos themselves run in tests/test_torch_demos_cascade.py).
"""

import json

import numpy as np
import pytest
import torch

from g1_locomotion_tpu_torch.api import cli, demos
from g1_locomotion_tpu_torch.utils import checkpoint


def test_pod_sweep_resume(tmp_path):
    path = str(tmp_path / "sweep_ckpt")
    kw = dict(scenarios=8, n_periods=2, device="cpu")
    # "Interrupted" run: only the first of two chunks executes.
    out1 = demos.demo_pod_sweep(checkpoint_path=path, chunks=1, **kw)
    assert checkpoint.exists(path) and out1["chunks_run"] == 1
    # Resume: chunk 0 is skipped, only chunk 1 runs.
    out2 = demos.demo_pod_sweep(checkpoint_path=path, chunks=2, **kw)
    assert out2["chunks_run"] == 1 and np.isfinite(out2["mean_com_drift"])
    # The resumed two-chunk sweep reports the statistics of one unchunked
    # run of the same total length, exactly: the drift from the run's
    # first tick, fell from the whole run's lowest heights.
    whole = demos.demo_pod_sweep(scenarios=8, n_periods=4, device="cpu")
    print(out2, whole)
    for key in ("mean_com_drift", "tau_max", "fell_fraction"):
        assert out2[key] == whole[key], key
    assert whole["devices"] == 1 and whole["fell_fraction"] == 0.0


def test_gait_sweep_cli(capsys):
    cli.main(["--device", "cpu", "gait-sweep", "--batch", "16"])
    out = json.loads(capsys.readouterr().out)
    assert out["config"] == "gait_sweep" and out["batch"] == 16 and out["device"] == "cpu"
    assert out["solves_per_s"] > 0 and out["max_pri_res"] < 0.05


# Each subcommand with every option set away from its default, and the
# keyword arguments its demo must receive (the reference CLI's wiring,
# g1_locomotion_tpu/api/cli.py:53-90; no --device: the card at float32,
# except walking-mujoco, which is float64 always and takes no dtype).
CLI_CASES = {
    "walking": (["--seconds", "1.5", "--vx", "0.2", "--steps", "3", "--log", "l.npz",
                 "--plot", "p.png"],
                "demo_walking", dict(seconds=1.5, v_cmd=(0.2, 0.0), n_steps=3, log_path="l.npz",
                                     plot_path="p.png", device=None, dtype=torch.float32)),
    "walking-mujoco": (["--steps", "4", "--vx", "0.05", "--view"], "demo_walking_mujoco",
                       dict(n_steps=4, v_cmd=(0.05, 0.0), view=True, device=None)),
    "push-recovery": (["--push-x", "0.1", "--push-y", "-0.05", "--horizon", "10"],
                      "demo_push_recovery", dict(push_velocity=(0.1, -0.05), horizon=10,
                                                 device=None, dtype=torch.float32)),
    "wbid-29dof": ([], "demo_wbid_29dof", dict(device=None, dtype=torch.float32)),
    "carry-walk": ([], "demo_carry_walk", dict(device=None, dtype=torch.float32)),
}


@pytest.mark.parametrize("cmd", list(CLI_CASES))
def test_unported_demos_name_the_roadmap(cmd, monkeypatch, capsys):
    """Once these five subcommands exited naming ROADMAP.md A.19; now each
    reaches its demo with the reference CLI's arguments."""
    argv, demo, want = CLI_CASES[cmd]
    calls = []
    monkeypatch.setattr(demos, demo, lambda **kw: calls.append(kw) or {"config": demo})
    cli.main([cmd, *argv])
    assert calls == [want]
    assert json.loads(capsys.readouterr().out) == {"config": demo}
