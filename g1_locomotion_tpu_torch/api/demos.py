"""Demo entry points of the BASELINE.json configs.

Port of ``g1_locomotion_tpu/api/demos.py``, with the reference's arguments
and result keys: config 1, straight-line walking (:func:`demo_walking`)
and the same under real MuJoCo contacts (:func:`demo_walking_mujoco`);
config 2, push recovery (:func:`demo_push_recovery`); config 3, the batched
MPC gait sweep (:func:`demo_gait_sweep`); config 4, the 29-DoF cascade
(:func:`demo_wbid_29dof`) and the with-hand carry walk
(:func:`demo_carry_walk`); config 5, the domain-randomized scenario sweep
with checkpoint / resume (:func:`demo_pod_sweep`). Each returns a result
dict. Run through the CLI:

    python -m g1_locomotion_tpu_torch.api.cli walking --seconds 2
    python -m g1_locomotion_tpu_torch.api.cli push-recovery
    python -m g1_locomotion_tpu_torch.api.cli gait-sweep --batch 4096
    python -m g1_locomotion_tpu_torch.api.cli pod-sweep --scenarios 4096

Every demo runs on the card unless the caller names another device, and
each result names its device.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from g1_locomotion_tpu_torch._device import require_cuda
from g1_locomotion_tpu_torch.core import rotations as rot
from g1_locomotion_tpu_torch.engine import tick as eng
from g1_locomotion_tpu_torch.models import srbd
from g1_locomotion_tpu_torch.models.robot import load_robot
from g1_locomotion_tpu_torch.mpc import solver as mpc
from g1_locomotion_tpu_torch.parallel import mesh as pmesh
from g1_locomotion_tpu_torch.parallel import sweep
from g1_locomotion_tpu_torch.utils import checkpoint as ckpt
from g1_locomotion_tpu_torch.utils import viz
from g1_locomotion_tpu_torch.utils.stats import synchronize


def _device(device) -> torch.device:
    return require_cuda() if device is None else torch.device(device)


def _standing(params: eng.ScenarioParams) -> eng.ScenarioParams:
    """The scenario with no steps: quiet standing."""
    return params._replace(gait=params.gait._replace(n_steps=torch.zeros_like(
        params.gait.n_steps)))


def _rollout(model, cfg, params, n_periods: int, state=None):
    """(final state, the log of n_periods periods with the batch axis of one
    dropped: (periods, ticks, ...) as the reference's)."""
    loop = eng.ControlLoop(model, cfg)
    if state is None:
        state = eng.init_state(model, cfg, 1, model.dtype)
    final, logs = loop.rollout(state, params, n_periods)
    synchronize(logs)
    return final, eng.TickLog(*(f[0] for f in logs))


def demo_walking(
    seconds: float = 6.5,
    v_cmd=(0.1, 0.0),
    n_steps: int = 8,
    dtype=torch.float64,
    log_path: Optional[str] = None,
    plot_path: Optional[str] = None,
    device=None,
):
    """Config 1: straight-line walking of the G1 23-DoF (SRBD MPC and WBID
    cascade, ``walking_config``: horizon 20, the validated configuration):
    n_steps steps and the settle back to quiet standing. With log_path the
    log is saved (utils.viz.save_log), with plot_path plotted."""
    device = _device(device)
    model = load_robot("g1_23dof", device=device, dtype=dtype)
    cfg = eng.walking_config()
    params = eng.walking_scenario(device=device, dtype=dtype, n_steps=float(n_steps),
                                  v_cmd=v_cmd)
    t0 = time.perf_counter()
    _, logs = _rollout(model, cfg, params, int(seconds / cfg.mpc.dt))
    wall = time.perf_counter() - t0
    com = logs.com.reshape(-1, 3).cpu().numpy()
    result = {
        "config": "walking",
        "device": str(device),
        "sim_seconds": seconds,
        "wall_seconds": wall,
        "final_com": com[-1].tolist(),
        "com_x_travel": float(com[-1, 0] - com[0, 0]),
        "fell": bool(com[-1, 2] < 0.5 or abs(com[-1, 1]) > 0.3),
    }
    if log_path:
        viz.save_log(log_path, logs)
    if plot_path:
        viz.plot_rollout({k: v.cpu().numpy() for k, v in zip(logs._fields, logs)}, plot_path)
    return result


def demo_walking_mujoco(n_steps: int = 6, v_cmd=(0.1, 0.0), view: bool = False, device=None):
    """Config 1 under real MuJoCo contacts: the validated 6-step walk
    (``mujoco_walking_scenario``) and the settle to quiet standing, for
    0.5 + 0.6 n_steps + 1.5 s. Always float64: MuJoCo runs on the host, the
    controller on ``device``."""
    from g1_locomotion_tpu_torch.engine.mujoco_bridge import MujocoLoop

    device = _device(device)
    model = load_robot("g1_23dof", device=device, dtype=torch.float64)
    cfg = eng.walking_config()
    params = eng.mujoco_walking_scenario(device=device, dtype=torch.float64,
                                         n_steps=float(n_steps), v_cmd=v_cmd)
    loop = MujocoLoop(model, cfg=cfg, params=params, view=view)
    t0 = time.perf_counter()
    total = int((0.5 + n_steps * 0.6 + 1.5) * 1000)
    log = loop.run(total)
    com = log["com"]
    return {
        "config": "walking_mujoco",
        "device": str(device),
        "n_steps": n_steps,
        "sim_seconds": total / 1000.0,
        "wall_seconds": time.perf_counter() - t0,
        "final_com": com[-1].tolist(),
        "com_x_travel": float(com[-1, 0] - com[0, 0]),
        "final_qvel_max": float(np.abs(loop.mj_data.qvel).max()),
        "fell": bool(com[:, 2].min() < 0.42),
        "solve_stats": loop.stats.export(),
    }


def demo_push_recovery(push_velocity=(0.25, 0.15), horizon: int = 20, seconds: float = 2.5,
                       dtype=torch.float64, device=None):
    """Config 2: standing balance and push recovery at MPC horizon N = 20.
    The push is an initial base velocity; recovered = the CoM back near its
    height with a small residual speed. The default (0.25, 0.15) m/s is the
    edge of the no-stepping envelope."""
    device = _device(device)
    model = load_robot("g1_23dof", device=device, dtype=dtype)
    cfg = eng.EngineConfig(mpc=mpc.MPCConfig(horizon=horizon))
    params = _standing(eng.default_scenario(device=device, dtype=dtype))
    state = eng.init_state(model, cfg, 1, dtype)
    v = state.v.clone()
    v[:, 0], v[:, 1] = push_velocity[0], push_velocity[1]  # base-local = world at zero yaw
    final, logs = _rollout(model, cfg, params, int(seconds / cfg.mpc.dt), state._replace(v=v))
    com = logs.com.reshape(-1, 3).cpu().numpy()
    speed = float(torch.linalg.vector_norm(final.v[0, :6]))
    return {
        "config": "push_recovery",
        "device": str(device),
        "horizon": horizon,
        "push": list(push_velocity),
        "final_com": com[-1].tolist(),
        "residual_speed": speed,
        "recovered": bool(com[-1, 2] > 0.5 and speed < 0.2),
    }


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


def demo_wbid_29dof(dtype=torch.float64, device=None):
    """Config 4: the G1 29-DoF, the full WBID QP cascaded under the SRBD MPC
    (the default ``EngineConfig``), standing for 10 periods."""
    device = _device(device)
    model = load_robot("g1_29dof", device=device, dtype=dtype)
    cfg = eng.EngineConfig()
    params = _standing(eng.default_scenario(device=device, dtype=dtype))
    _, logs = _rollout(model, cfg, params, 10)
    com = logs.com.reshape(-1, 3).cpu().numpy()
    return {
        "config": "wbid_29dof",
        "device": str(device),
        "nv": model.nv,
        "final_com": com[-1].tolist(),
        "stable": bool(abs(com[-1, 2] - cfg.com_height) < 0.05),
    }


def demo_carry_walk(dtype=torch.float64, n_periods: int = 200, device=None):
    """Config 4 walking: the g1_29dof_with_hand carry walk, the 8-step walk
    with the hand hold tasks (each hand keeps its standing base-relative
    pose, following the yaw) and the variant's gains
    (``variant_walking_config`` / ``variant_walking_scenario``); the log
    carries q (``log_q``) for the 3D replay."""
    device = _device(device)
    model = load_robot("g1_29dof_with_hand", device=device, dtype=dtype)
    cfg = eng.variant_walking_config(model)._replace(log_q=True)
    params = eng.variant_walking_scenario(model, dtype=dtype, n_steps=8.0, v_cmd=(0.1, 0.0))
    final, logs = _rollout(model, cfg, params, n_periods)
    com = logs.com.reshape(-1, 3).cpu().numpy()
    contact = logs.contact.reshape(-1, 4).cpu().numpy()
    left_up = (contact[:, 0] < 0.5).astype(int)
    right_up = (contact[:, 2] < 0.5).astype(int)
    rpy = rot.quat_to_rpy(final.q[0, 3:7]).cpu().numpy()
    v_max = float(final.v.abs().max())
    return {
        "config": "carry_walk_29dof_with_hand",
        "device": str(device),
        "nv": model.nv,
        "z_min": float(com[:, 2].min()),
        "z_final": float(com[-1, 2]),
        "v_final_max": v_max,
        "rpy_final_max": float(np.abs(rpy[:2]).max()),
        "steps": [int(np.clip(np.diff(left_up), 0, 1).sum()),
                  int(np.clip(np.diff(right_up), 0, 1).sum())],
        "walks": bool(np.isfinite(com).all() and com[:, 2].min() > 0.45
                      and abs(com[-1, 2] - cfg.com_height) < 0.02 and v_max < 0.3),
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
