"""api/demos.py and api/cli.py of the PyTorch port, on the CPU at float64.

* ``demo_pod_sweep``'s checkpoint / resume (``tests/test_sweep_resume.py``'s
  check): an interrupted two-chunk sweep resumed from its checkpoint
  reports the statistics of one unchunked run of the same length.
* ``demo_gait_sweep`` at a small batch: finite, every solve's residual
  small.
* The CLI: the sweeps run on the CPU when asked; the subcommands whose
  demos are not ported exit with a message naming ROADMAP.md A.19.
"""

import json

import numpy as np
import pytest

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


@pytest.mark.parametrize("cmd", cli.NOT_PORTED)
def test_unported_demos_name_the_roadmap(cmd):
    with pytest.raises(SystemExit, match="A.19"):
        cli.main([cmd])
