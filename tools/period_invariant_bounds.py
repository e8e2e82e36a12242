"""The JAX package at float32 on the CPU, on the chains that chip_smoke.py's
phases 7, 8, 10, 11, 13 and 15 drive the PyTorch port through: the largest
value of each invariant it gives there. chip_smoke.py holds the port to
twice these (PERIOD_BOUNDS, SRBD_BOUNDS).

    JAX_PLATFORMS=cpu python tools/period_invariant_bounds.py [CASE ...]

Cases (all when none is named):

* ``serving`` (phase 7): 25 control periods (1.0 s: the stand, the first
  double support and the first swing) from ``init_state`` in the serving
  configuration of ``tools/bench_tick_p99.py`` (``polish_kernel`` on both
  QPs, ``fast_stack``; the Pallas kernels in interpret mode),
  ``default_scenario``, B = 1;
* ``batched`` (phase 8): one period of the default ``EngineConfig`` from
  ``init_state``, ``default_scenario``; ``tools/bench_cascade.py``
  broadcasts that one instance to B = 2048, so one instance gives the
  batch's maxima;
* ``g1_29dof``, ``g1_29dof_with_hand`` (phase 13): one period of the
  default ``EngineConfig`` with the variant's torso / hand tasks
  (``variant_walking_config``), ``variant_walking_scenario``, from
  ``init_state``; broadcast on the card, so one instance here;
* ``srbd_batched`` (phase 10): the SRBD loop (``mpc/srbd_loop.py``) in
  ``MPCConfig()`` with ``walking_scenario``, 200 periods, each instance
  kicked laterally at period 60 (``chip_smoke.srbd_kicks``), vmapped over
  the first ``SRBD_BOUNDS_B`` of phase 10's 4096 instances;
* ``srbd_serving`` (phase 11): the same loop with ``polish_kernel`` (the
  Pallas kernels in interpret mode), 50 periods, B = 1, no kick;
* ``sweep`` (phase 15): the pod sweep's domain-randomized batch as the
  port draws it (``parallel/sweep.randomize``, a seeded CPU generator;
  SRBD mass and inertia, WBID mu, swing duration, step length and v_cmd per
  instance), all 4096 vmapped ``SWEEP_BOUNDS_B`` at a time through
  ``SWEEP_PERIODS`` periods of the default ``EngineConfig``;
* ``sweep_port``: not the JAX package but the port, at f32 on the CPU, on
  the first ``SWEEP_BOUNDS_B`` of those scenarios (beside the JAX
  package's maxima on the same ones, which ``sweep`` prints for each chunk).

The control-period invariants (``chip_smoke.period_maxima``): MPC and WBID
pri_res, the largest force on a swinging foot's contacts, the largest
deviation of the summed normal force from m g in double support, the
base's tilt from upright, |tau| beyond tau_max, non-finite values; the SRBD
loop's (``chip_smoke.srbd_maxima``): pri_res, the force on a swinging
foot's contacts, the CoM height's deviation from its target, non-finite
values. Prints one JSON line. The control periods' XLA compiles take a few
minutes each.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from unittest import mock

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from g1_locomotion_tpu.engine import tick as eng  # noqa: E402
from g1_locomotion_tpu.models.robot import load_robot  # noqa: E402
from g1_locomotion_tpu.mpc import solver as mpc  # noqa: E402
from g1_locomotion_tpu.mpc import srbd_loop  # noqa: E402
from g1_locomotion_tpu.ops import pallas_lin  # noqa: E402

F32 = jnp.float32
SRBD_BOUNDS_B = 512  # phase 10's first instances run here
SWEEP_BOUNDS_B = 512  # phase 15: scenarios a compiled chunk takes


def serving(cfg):
    return cfg._replace(
        mpc=cfg.mpc._replace(qp=cfg.mpc.qp._replace(polish_kernel=True)),
        wbid=cfg.wbid._replace(qp=cfg.wbid.qp._replace(polish_kernel=True), fast_stack=True))


def interpret():
    """The Pallas kernels in interpret mode (the CPU has no TPU)."""
    gj, gji, admm = pallas_lin.gj_solve, pallas_lin.gj_inverse, pallas_lin.admm_iterate
    return (mock.patch.object(pallas_lin, "gj_solve", lambda K, b: gj(K, b, interpret=True)),
            mock.patch.object(pallas_lin, "gj_inverse", lambda K: gji(K, interpret=True)),
            mock.patch.object(pallas_lin, "admm_iterate",
                              lambda *a, **kw: admm(*a, **kw, interpret=True)))


def chain_maxima(model, cfg, periods: int, params=None) -> dict:
    cfg = cfg._replace(log_q=True)
    params = eng.default_scenario(F32) if params is None else params
    rollout = eng.make_rollout(model, cfg)
    a, b, c = interpret()
    with a, b, c:
        _, log = jax.jit(lambda s: rollout(s, params, periods))(eng.init_state(model, cfg, F32))
    log = {k: np.asarray(v) for k, v in log._asdict().items()}
    mg = float(np.asarray(jnp.sum(model.mass))) * 9.80665
    return cs.period_maxima(log, np.asarray(model.tau_max), mg)


def variant_maxima(variant: str) -> dict:
    model = load_robot(variant, dtype=F32)
    vcfg = eng.variant_walking_config(model)
    cfg = eng.EngineConfig()._replace(torso_task=vcfg.torso_task, hand_task=vcfg.hand_task)
    return chain_maxima(model, cfg, 1, eng.variant_walking_scenario(model, F32))


def srbd_maxima(cfg, periods: int, batch: int) -> dict:
    params = eng.walking_scenario(F32)
    rollout = srbd_loop.make_srbd_loop(cfg)
    state = srbd_loop.init_loop_state(cfg, cs.SRBD_COM_HEIGHT, F32)
    if batch == 1:
        a, b, c = interpret()
        with a, b, c:
            _, log = jax.jit(lambda s: rollout(s, params, periods))(state)
        log = {k: np.asarray(v)[None] for k, v in log._asdict().items()}
    else:
        kicks = jnp.asarray(cs.srbd_kicks(batch, periods), F32)
        states = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape), state)
        _, log = jax.jit(jax.vmap(lambda s, k: rollout(s, params, periods, k)))(states, kicks)
        log = {k: np.asarray(v) for k, v in log._asdict().items()}
    return cs.srbd_maxima(log)


def sweep_maxima(chunk: int) -> dict:
    """Phase 15's pod sweep: the port's own randomized batch (its
    ``parallel/sweep.randomize`` of ``SweepSpec()``'s 4096 scenarios on a
    CPU generator of seed ``chip_smoke.SWEEP_SEED``, through numpy), every
    leaf tiled and vmapped as the JAX package's sweep does, ``chunk``
    scenarios at a time through one compiled program; the default
    ``EngineConfig``, ``chip_smoke.SWEEP_PERIODS`` periods from
    ``init_state``. The maxima over all the scenarios."""
    import torch

    from g1_locomotion_tpu_torch.engine import tick as teng
    from g1_locomotion_tpu_torch.parallel import sweep as tsweep

    draw = tsweep.randomize(tsweep.SweepSpec(), torch.Generator().manual_seed(cs.SWEEP_SEED),
                            teng.default_scenario(device="cpu", dtype=torch.float32))
    model = load_robot("g1_23dof", dtype=F32)
    cfg = eng.EngineConfig(log_q=True)
    rollout = eng.make_rollout(model, cfg)
    state = eng.init_state(model, cfg, F32)
    run = jax.jit(jax.vmap(lambda p: rollout(state, p, cs.SWEEP_PERIODS)))
    base = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (chunk,) + x.shape),
                                  eng.default_scenario(F32))
    mg = float(np.asarray(jnp.sum(model.mass))) * 9.80665
    worst = None
    for start in range(0, draw.batch(), chunk):
        def rows(t):
            return jnp.asarray(t[start:start + chunk].numpy(), F32)

        params = base._replace(
            srbd=base.srbd._replace(mass=rows(draw.srbd.mass), inertia=rows(draw.srbd.inertia)),
            wbid_gains=base.wbid_gains._replace(mu=rows(draw.wbid_gains.mu)),
            gait=base.gait._replace(swing_duration=rows(draw.gait.swing_duration)),
            steps=base.steps._replace(step_length=rows(draw.steps.step_length)),
            v_cmd=rows(draw.v_cmd))
        _, log = run(params)
        m = cs.period_maxima({k: np.asarray(v) for k, v in log._asdict().items()},
                             np.asarray(model.tau_max), mg)
        worst = m if worst is None else {k: (worst[k] + m[k] if k == "non_finite"
                                             else max(worst[k], m[k])) for k in m}
        print(f"sweep scenarios {start}-{start + chunk - 1}: {m}", file=sys.stderr, flush=True)
    return worst


def port_sweep_maxima(batch: int) -> dict:
    """The port itself (torch, f32, on the CPU) on the first ``batch`` of
    phase 15's scenarios, for the same maxima: where the two packages'
    f32 rounding spreads differ."""
    import torch

    from g1_locomotion_tpu_torch.engine import tick as teng
    from g1_locomotion_tpu_torch.models.robot import load_robot as load_port_robot
    from g1_locomotion_tpu_torch.parallel import sweep as tsweep

    cpu, f32 = torch.device("cpu"), torch.float32
    model = load_port_robot("g1_23dof", device=cpu, dtype=f32)
    loop = teng.ControlLoop(model, teng.EngineConfig(log_q=True))
    params = tsweep.randomize(tsweep.SweepSpec(), torch.Generator().manual_seed(cs.SWEEP_SEED),
                              teng.default_scenario(device=cpu, dtype=f32)).rows(slice(0, batch))
    state = teng.init_state(model, loop.cfg, batch, f32)
    tau_max, mg = model.tau_max.double().numpy(), float(model.total_mass) * 9.80665
    worst = None
    for _ in range(cs.SWEEP_PERIODS):
        state, log = loop.period(state, params)
        m = cs.period_maxima(cs.log_numpy(log), tau_max, mg)
        worst = m if worst is None else {k: (worst[k] + m[k] if k == "non_finite"
                                             else max(worst[k], m[k])) for k in m}
    return worst


CASES = {
    "serving": lambda: chain_maxima(load_robot("g1_23dof", dtype=F32),
                                    serving(eng.EngineConfig()), cs.SERVING_PERIODS),
    "batched": lambda: chain_maxima(load_robot("g1_23dof", dtype=F32), eng.EngineConfig(), 1),
    "g1_29dof": lambda: variant_maxima("g1_29dof"),
    "g1_29dof_with_hand": lambda: variant_maxima("g1_29dof_with_hand"),
    "srbd_batched": lambda: srbd_maxima(mpc.MPCConfig(), cs.SRBD_PERIODS, SRBD_BOUNDS_B),
    "sweep": lambda: sweep_maxima(SWEEP_BOUNDS_B),
    "sweep_port": lambda: port_sweep_maxima(SWEEP_BOUNDS_B),
    "srbd_serving": lambda: srbd_maxima(
        mpc.MPCConfig()._replace(qp=mpc.MPCConfig().qp._replace(polish_kernel=True)),
        cs.SRBD_SERVING_PERIODS, 1),
}


def main(argv) -> None:
    names = argv or list(CASES)
    unknown = [n for n in names if n not in CASES]
    if unknown:
        raise SystemExit(f"unknown cases {unknown}; choose from {list(CASES)}")
    out = {"platform": jax.devices()[0].platform, "dtype": "float32"}
    out.update({name: CASES[name]() for name in names})
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
