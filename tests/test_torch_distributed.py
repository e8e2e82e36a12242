"""The PyTorch port's scenario sweep across processes (``parallel/mesh.py``
with the Gloo backend on the CPU, float64): two processes of
``tools/torch_distributed_worker.py`` each run half of a randomized batch,
and their all-reduced ``SweepStats`` equal one process's run of the same
two halves exactly, and of the whole batch at once to 1e-4 relative; ``entry.dryrun_multichip`` on two Gloo processes. The port's
counterpart of ``tests/test_distributed.py``."""

import json
import socket
import subprocess
import sys
from pathlib import Path

import torch

from g1_locomotion_tpu_torch import entry
from g1_locomotion_tpu_torch.engine import tick as eng
from g1_locomotion_tpu_torch.models.robot import load_robot
from g1_locomotion_tpu_torch.parallel import mesh, sweep

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tools" / "torch_distributed_worker.py"
sys.path.insert(0, str(WORKER.parent))

from torch_distributed_worker import sweep_stats  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _halves(scenarios: int, periods: int) -> dict:
    """One process's run of the batch as the two workers split it: each
    half through run_sweep, the statistics combined as the all-reduce
    does (sum, sum, max, sum)."""
    cpu, f64 = torch.device("cpu"), torch.float64
    model = load_robot("g1_23dof", device=cpu, dtype=f64)
    params = sweep.randomize(sweep.SweepSpec(n_scenarios=scenarios),
                             torch.Generator().manual_seed(0),
                             eng.default_scenario(device=cpu, dtype=f64))
    loop = eng.ControlLoop(model, eng.EngineConfig())
    parts = [sweep.run_sweep(loop, params.rows(mesh.row_slice(scenarios, r, 2)), periods)[2]
             for r in range(2)]
    return {k: float(max(getattr(s, k) for s in parts) if op == "max"
                     else sum(getattr(s, k) for s in parts))
            for k, op in sweep.REDUCE_OPS._asdict().items()}


def test_two_process_sweep_matches_single_process(tmp_path):
    init = f"tcp://localhost:{_free_port()}"
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(tmp_path),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), init, "2", str(rank),
                               "--device", "cpu", "--periods", "1"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for rank in range(2)]
    split = _halves(8, 1)
    whole = sweep_stats(torch.device("cpu"), 8, 1)
    outs = [p.communicate(timeout=300) + (p.returncode,) for p in procs]
    for out, err, rc in outs:
        assert rc == 0, (rc, out[-500:], err[-2000:])
        line = json.loads(out.strip().splitlines()[-1])
        print(line, split, whole)
        assert line["ok"] and line["n"] == whole["n"] == 8.0, (line, whole)
        # The same rows in one process: the all-reduce gives exactly their
        # combined statistics.
        assert all(line[k] == split[k] for k in split), (line, split)
        # The whole batch at once (B = 8 against the workers' 4 each):
        # batched products of another width round apart, and the closed
        # loop's QPs amplify it (measured 2.2e-5 relative on the drift, a
        # sum of ~1 mm drifts); the reference's test holds its workers to
        # 1e-4 for the same reason.
        assert line["fell_count"] == whole["fell_count"]
        for name in ("com_drift_sum", "tau_max"):
            assert abs(line[name] - whole[name]) <= 1e-4 * abs(whole[name]), (name, line, whole)


def test_dryrun_multichip_on_gloo():
    entry.dryrun_multichip(2, device="cpu")
