"""Demo entry points of the BASELINE.json configs that the port runs.

Port of ``g1_locomotion_tpu/api/demos.py``: config 3, the batched MPC gait
sweep (:func:`demo_gait_sweep`), and config 5, the domain-randomized
scenario sweep with checkpoint / resume (:func:`demo_pod_sweep`). Each
returns a result dict. Run through the CLI:

    python -m g1_locomotion_tpu_torch.api.cli gait-sweep --batch 4096
    python -m g1_locomotion_tpu_torch.api.cli pod-sweep --scenarios 4096

The reference's other demos (walking, walking in MuJoCo, push recovery, the
29-DoF WBID, the carry walk) are not ported yet (ROADMAP.md, item A.19).
Every demo runs on the card unless the caller names another device.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from g1_locomotion_tpu_torch._device import require_cuda
from g1_locomotion_tpu_torch.engine import tick as eng
from g1_locomotion_tpu_torch.models import srbd
from g1_locomotion_tpu_torch.models.robot import load_robot
from g1_locomotion_tpu_torch.mpc import solver as mpc
from g1_locomotion_tpu_torch.parallel import mesh as pmesh
from g1_locomotion_tpu_torch.parallel import sweep
from g1_locomotion_tpu_torch.utils import checkpoint as ckpt
from g1_locomotion_tpu_torch.utils.stats import synchronize


def _device(device) -> torch.device:
    return require_cuda() if device is None else torch.device(device)


def demo_gait_sweep(batch: int = 4096, dtype=torch.float32, device=None):
    """Config 3: the batched MPC gait sweep, ``batch`` SRBD-MPC solves
    (velocity perturbations x contact patterns: standing, left foot up,
    right foot up) as one batched QP solve. Times the second call (the
    first builds the kernels)."""
    device = _device(device)
    cfg = mpc.MPCConfig(horizon=10)
    weights = mpc.default_weights(device=device, dtype=dtype)
    params = srbd.default_params(device=device, dtype=dtype)
    N = cfg.horizon
    com = torch.tensor([0.0527, 0.0, 0.598], dtype=dtype)
    feet = torch.tensor([[-0.05, 0.12, 0.0], [0.12, 0.12, 0.0],
                         [-0.05, -0.12, 0.0], [0.12, -0.12, 0.0]], dtype=dtype)
    x0 = torch.zeros(13, dtype=dtype)
    x0[3:6] = com
    x0[12] = srbd.GRAVITY

    gen = torch.Generator().manual_seed(0)
    pattern = torch.randint(0, 3, (batch,), generator=gen)
    stand = torch.ones((N, 4), dtype=dtype)
    left_up, right_up = stand.clone(), stand.clone()
    left_up[:, :2] = 0.0
    right_up[:, 2:] = 0.0
    contact = torch.stack([stand, left_up, right_up])[pattern].to(device)
    x0s = x0.repeat(batch, 1)
    x0s[:, 9:11] += -0.3 + 0.6 * torch.rand((batch, 2), generator=gen, dtype=dtype)
    x0s = x0s.to(device)
    x_ref, c_hor, p_hor = (t.to(device) for t in (x0.repeat(N, 1), feet.repeat(N, 1, 1),
                                                  com.repeat(N, 1)))

    def solve():
        return mpc.solve(cfg, weights, params, x0s, x_ref, contact, c_hor, p_hor)

    synchronize(solve())  # the first call builds the kernels
    t0 = time.perf_counter()
    sols = solve()
    synchronize(sols)
    dt = time.perf_counter() - t0
    return {
        "config": "gait_sweep",
        "batch": batch,
        "device": str(device),
        "solves_per_s": batch / dt,
        "max_pri_res": float(sols.pri_res.max()),
    }


def demo_pod_sweep(
    scenarios: int = 4096,
    n_periods: int = 5,
    dtype=torch.float64,
    checkpoint_path: Optional[str] = None,
    chunks: int = 1,
    device=None,
):
    """Config 5: the domain-randomized scenario sweep of the default
    ``EngineConfig``, its rows split over the processes of a
    ``torch.distributed`` job (one process: the whole batch), the
    statistics reduced across them.

    With ``checkpoint_path`` the sweep runs in ``chunks`` segments of
    ``n_periods`` each and saves (engine states, accumulated statistics, the
    drift origin, the lowest CoM height so far, the chunk index) after every
    segment, one file per process; a sweep run again resumes after the last
    finished segment, with the statistics of an unchunked run."""
    device = _device(device)
    rank, world = pmesh.rank_world()
    model = load_robot("g1_23dof", device=device, dtype=dtype)
    cfg = eng.EngineConfig()
    base = eng.default_scenario(device=device, dtype=dtype)
    spec = sweep.SweepSpec(n_scenarios=scenarios)
    params = sweep.randomize(spec, torch.Generator().manual_seed(0), base)
    loop = eng.ControlLoop(model, cfg)
    if checkpoint_path and world > 1:
        checkpoint_path = f"{checkpoint_path}_rank{rank}"

    states = stats_acc = com_ref = min_z_acc = None
    start_chunk = 0
    if checkpoint_path and ckpt.exists(checkpoint_path):
        rows = pmesh.row_slice(scenarios, rank, world)
        b = rows.stop - rows.start
        zero = torch.zeros((), dtype=dtype, device=device)
        like = (eng.init_state(model, cfg, b, dtype),
                sweep.SweepStats(n=zero, com_drift_sum=zero, tau_max=zero, fell_count=zero),
                torch.zeros((b, 3), dtype=dtype, device=device),
                torch.zeros((b,), dtype=dtype, device=device))
        (states, stats_acc, com_ref, min_z_acc), meta = ckpt.restore(checkpoint_path, like)
        start_chunk = int(meta.get("chunk", 0))

    t0 = time.perf_counter()
    for chunk in range(start_chunk, max(chunks, 1)):
        states, (com_start, min_z), stats = sweep.run_sweep(
            loop, params, n_periods=n_periods, states0=states, com_ref=com_ref)
        if com_ref is None:
            com_ref = com_start  # the whole run's drift origin (chunk 0, tick 0)
        min_z_acc = min_z if min_z_acc is None else torch.minimum(min_z_acc, min_z)
        # Chunk-exact accumulation: every chunk measures the drift from the
        # run's origin, so the latest replaces; tau_max takes the maximum;
        # fell is recounted below from the whole run's lowest heights.
        stats_acc = stats if stats_acc is None else stats._replace(
            tau_max=torch.maximum(stats_acc.tau_max, stats.tau_max))
        if checkpoint_path:
            ckpt.save(checkpoint_path, (states, stats_acc, com_ref, min_z_acc),
                      meta={"chunk": chunk + 1})
    synchronize(stats_acc)
    wall = time.perf_counter() - t0
    fell = (min_z_acc < sweep.FALL_HEIGHT).to(dtype).sum()
    fell = pmesh.all_reduce_stats(fell, "sum")
    return {
        "config": "pod_sweep",
        "scenarios": scenarios,
        "devices": world,
        "device": str(device),
        "chunks_run": max(chunks, 1) - start_chunk,
        "wall_seconds": wall,
        "mean_com_drift": float(stats_acc.com_drift_sum / stats_acc.n),
        "tau_max": float(stats_acc.tau_max),
        "fell_fraction": float(fell) / float(stats_acc.n),
    }
