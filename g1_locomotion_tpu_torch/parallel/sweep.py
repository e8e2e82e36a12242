"""Scenario sweeps: domain randomization over batched closed-loop rollouts.

Port of ``g1_locomotion_tpu/parallel/sweep.py`` (BASELINE.json configs 3
and 5): thousands of scenarios of the control period as one batch on a
card (velocity commands, gait timings, mass and friction randomized), the
batch split over processes by ``parallel/mesh.py``, the sweep statistics
reduced across them.

The draws come from a ``torch.Generator``: they cannot match
``jax.random``'s, so a comparison with the reference runs the reference's
batch through ``convert.scenario_batch``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from g1_locomotion_tpu_torch.engine import tick as eng
from g1_locomotion_tpu_torch.parallel import mesh as pmesh


class SweepSpec(NamedTuple):
    """Randomization ranges for a domain-randomized sweep."""

    n_scenarios: int = 4096
    v_cmd_x: tuple = (-0.2, 0.5)     # m/s forward command range
    v_cmd_y: tuple = (-0.1, 0.1)
    mass_scale: tuple = (0.9, 1.1)   # body-mass randomization
    friction: tuple = (0.5, 1.0)     # cone friction range
    swing_duration: tuple = (0.20, 0.32)
    step_length: tuple = (0.05, 0.15)


def randomize(spec: SweepSpec, generator: torch.Generator,
              base: eng.ScenarioParams) -> eng.ScenarioParams:
    """A batch of ScenarioParams: v_cmd (B, 2), SRBD mass (B,) and inertia
    (B, 3, 3), WBID mu (B,), gait swing_duration (B,) and steps step_length
    (B,) drawn uniformly from ``spec``'s ranges on the generator's device,
    then moved to base's; every other leaf stays base's, shared. As in the
    reference, the inertia is scaled by the mass's own draw."""
    B = spec.n_scenarios
    dtype, device = base.v_cmd.dtype, base.v_cmd.device

    def u(lohi):
        draw = torch.rand((B,), generator=generator, dtype=dtype, device=generator.device)
        return (lohi[0] + (lohi[1] - lohi[0]) * draw).to(device)

    v_cmd = torch.stack([u(spec.v_cmd_x), u(spec.v_cmd_y)], dim=1)
    scale = u(spec.mass_scale)
    return base._replace(
        srbd=base.srbd._replace(mass=base.srbd.mass * scale,
                                inertia=base.srbd.inertia * scale[:, None, None]),
        wbid_gains=base.wbid_gains._replace(mu=u(spec.friction)),
        gait=base.gait._replace(swing_duration=u(spec.swing_duration)),
        steps=base.steps._replace(step_length=u(spec.step_length)),
        v_cmd=v_cmd,
    )


class SweepStats(NamedTuple):
    """Statistics over the scenario axis, reduced across processes (the
    analogue of the original controller's pal_statistics topics)."""

    n: torch.Tensor
    com_drift_sum: torch.Tensor
    tau_max: torch.Tensor
    fell_count: torch.Tensor  # CoM below 0.4 m at any tick


REDUCE_OPS = SweepStats(n="sum", com_drift_sum="sum", tau_max="max", fell_count="sum")
FALL_HEIGHT = 0.4  # m


def run_sweep(
    loop: eng.ControlLoop,
    batch_params: eng.ScenarioParams,
    n_periods: int,
    states0: Optional[eng.EngineState] = None,
    com_ref: Optional[torch.Tensor] = None,
):
    """Run ``n_periods`` control periods of a batch of scenarios through
    ``loop`` (an ``engine.tick.ControlLoop``: the robot model and the
    ``EngineConfig``; the reference takes the two and builds its rollout,
    the port builds the loop once for every chunk) and reduce the sweep
    statistics. A period makes no host sync.

    Returns ``(final_states, (com_start, min_z), stats)``: ``stats`` reduced
    over every process's rows; ``com_start`` (b, 3) the CoM at the chunk's
    first tick and ``min_z`` (b,) the chunk's lowest CoM height, per
    scenario of this process's b rows (unreduced), so that chunked runs
    accumulate exactly. ``states0`` (optional, this process's rows) resumes
    from an earlier chunk's ``final_states``.

    ``com_ref`` (optional, (b, 3)): the CoM drift's origin per scenario. A
    chunked sweep passes the first chunk's ``com_start``, so that the last
    chunk's drift is measured from the whole run's first tick and equals an
    unchunked run's (summing per-chunk drifts would not: |a + b| is not
    |a| + |b|). ``fell`` is the whole chunk's minimum height against 0.4 m,
    so chunks combine by an element-wise minimum.

    Under ``torch.distributed`` every process holds the same ``batch_params``
    (drawn from the same seed) and runs its own contiguous rows
    (``mesh.shard_rows``). The statistics are reduced period by period, so
    no (B, periods, ticks, ...) log is kept.
    """
    if n_periods < 1:
        raise ValueError("run_sweep: n_periods must be at least 1")
    if batch_params.batch() is None:
        raise ValueError("run_sweep: batch_params has no per-instance leaf (see randomize)")
    rank, world = pmesh.rank_world()
    params = pmesh.shard_rows(batch_params, rank, world)
    dtype = params.v_cmd.dtype
    state = (eng.init_state(loop.model, loop.cfg, params.batch(), dtype) if states0 is None
             else states0)
    com_start = min_z = tau_max = None
    for _ in range(n_periods):
        state, log = loop.period(state, params)
        if com_start is None:
            com_start = log.com[:, 0]
        z = log.com[..., 2].amin(dim=1)
        tau = log.tau.abs().flatten(1).amax(dim=1)
        min_z = z if min_z is None else torch.minimum(min_z, z)
        tau_max = tau if tau_max is None else torch.maximum(tau_max, tau)
    origin = com_start if com_ref is None else com_ref
    drift = torch.linalg.vector_norm(log.com[:, -1] - origin, dim=-1)
    stats = SweepStats(
        n=torch.full((), drift.shape[0], dtype=dtype, device=drift.device),
        com_drift_sum=drift.sum(),
        tau_max=tau_max.amax(),
        fell_count=(min_z < FALL_HEIGHT).to(dtype).sum(),
    )
    return state, (com_start, min_z), pmesh.all_reduce_stats(stats, REDUCE_OPS)
