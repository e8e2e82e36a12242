"""Entry points: one control period on a card, and a multi-process dry run.

The port's counterpart of the repository's ``__graft_entry__.py``.
:func:`entry` returns a forward step on the flagship path (one control
period of the G1 engine: MPC solve, WBID ticks, plant) and its example
arguments; :func:`dryrun_multichip` runs one step of the scenario sweep on
``n`` processes, one card each (``parallel/mesh.py``), its statistics
reduced across them. Both take the card unless the caller names the CPU.

    python -m g1_locomotion_tpu_torch.entry
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist

from g1_locomotion_tpu_torch._device import require_cuda


def _small_config():
    """The reference's scaled-down flagship configuration: the production
    ``walking_config`` structure (factorization path, active-set polish,
    jointly optimized footsteps) with the horizon, iteration and tick counts
    shrunk."""
    from g1_locomotion_tpu_torch.engine import tick as eng
    from g1_locomotion_tpu_torch.mpc.solver import MPCConfig
    from g1_locomotion_tpu_torch.ops.qp import QPConfig
    from g1_locomotion_tpu_torch.wbid.solver import WBIDConfig

    return eng.EngineConfig(
        mpc=MPCConfig(
            horizon=6,
            footstep_opt=True,
            qp=QPConfig(iters=16, scaling_iters=0, rho=1.0, rho_segments=2,
                        matmul_inverse=False, polish_rounds=1),
        ),
        wbid=WBIDConfig(
            qp=QPConfig(iters=12, scaling_iters=3, rho=0.1, rho_segments=2,
                        matmul_inverse=False, polish_rounds=1)
        ),
        ticks_per_mpc=2,
    )


def entry(device=None):
    """(fn, example_args): one engine period (MPC solve + WBID ticks) of the
    small configuration at float32, B = 1."""
    from g1_locomotion_tpu_torch.engine import tick as eng
    from g1_locomotion_tpu_torch.models.robot import load_robot

    device = require_cuda() if device is None else torch.device(device)
    model = load_robot("g1_23dof", device=device, dtype=torch.float32)
    cfg = _small_config()
    loop = eng.ControlLoop(model, cfg)
    params = eng.default_scenario(device=device, dtype=torch.float32)
    state = eng.init_state(model, cfg, 1, torch.float32)

    def fn(state, params):
        final, logs = loop.rollout(state, params, 1)
        return final.q, logs.tau

    return fn, (state, params)


def _dryrun_worker(rank: int, n: int, init_method: str, device_type: str) -> None:
    from g1_locomotion_tpu_torch.engine import tick as eng
    from g1_locomotion_tpu_torch.models.robot import load_robot
    from g1_locomotion_tpu_torch.parallel import mesh as pmesh
    from g1_locomotion_tpu_torch.parallel import sweep

    device = pmesh.distributed_init(init_method, n, rank,
                                    device=None if device_type == "cuda" else "cpu")
    try:
        model = load_robot("g1_23dof", device=device, dtype=torch.float32)
        base = eng.default_scenario(device=device, dtype=torch.float32)
        params = sweep.randomize(sweep.SweepSpec(n_scenarios=2 * n),
                                 torch.Generator().manual_seed(0), base)
        _, _, stats = sweep.run_sweep(eng.ControlLoop(model, _small_config()), params,
                                      n_periods=1)
        if int(stats.n) != 2 * n or not bool(torch.isfinite(stats.com_drift_sum)):
            raise AssertionError(f"process {rank}: sweep statistics {stats}")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One step of the scenario sweep (2 scenarios a process) on
    ``n_devices`` processes, one card each (NCCL), or Gloo processes on the
    CPU when ``device`` names it; raises if a process fails."""
    device_type = "cuda" if device is None else torch.device(device).type
    if device_type == "cuda" and require_cuda() and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip: {n_devices} cards asked for, "
                           f"{torch.cuda.device_count()} present")
    torch.multiprocessing.start_processes(
        _dryrun_worker, args=(n_devices, f"tcp://localhost:{_free_port()}", device_type),
        nprocs=n_devices, start_method="spawn")


if __name__ == "__main__":
    fn, args = entry()
    q, tau = fn(*args)
    print("entry ok:", tuple(q.shape), tuple(tau.shape))
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun ok")
