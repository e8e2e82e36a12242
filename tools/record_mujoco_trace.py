"""Record the JAX package's MuJoCo closed loop, for the port's bridge.

    JAX_PLATFORMS=cpu python tools/record_mujoco_trace.py [--ticks 200]

Runs ``g1_locomotion_tpu/engine/mujoco_bridge.MujocoLoop`` on the CPU at
float64 in ``tests/test_engine_mujoco.py::test_standing_balance_in_mujoco``'s
configuration (the default ``EngineConfig``; ``default_scenario`` with no
steps and the stiff standing MPC weights) and writes, per tick, MuJoCo's
measured ``qpos`` / ``qvel`` before the tick (row 0 is the settled state
the loop hands its controller), the tick's torques, CoM and contact normal
forces, and MuJoCo's state after the last tick, to
``tests/torch_mujoco_trace.npz``. Running it again rewrites the file. The
port's bridge controller replays the measurements and is held against the
recorded torques (``tests/test_torch_mujoco.py``, ``chip_smoke.py`` phase
17, which reads only numpy and needs no MuJoCo).

``--compare-eager N`` also runs the JAX loop's first N ticks un-jitted on
the recorded measurements and prints how far each tick's torques are from
the jitted ones (the WBID QP's polish takes its acceptance decision at the
rounding level, so the two differ on some ticks; a few seconds a tick).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from g1_locomotion_tpu.engine import tick as eng  # noqa: E402
from g1_locomotion_tpu.engine.mujoco_bridge import MujocoLoop  # noqa: E402
from g1_locomotion_tpu.models.robot import load_robot  # noqa: E402
from g1_locomotion_tpu.mpc import solver as mpc  # noqa: E402

OUT = REPO / "tests" / "torch_mujoco_trace.npz"
# test_standing_balance_in_mujoco's MPC weights (tests/test_engine_mujoco.py:25-34).
Q_STAND = (40.0, 40.0, 50.0, 200.0, 200.0, 500.0, 0.5, 0.5, 0.5, 10.0, 10.0, 10.0, 0.0)
R_STAND = 1e-5


def standing_params():
    params = eng.default_scenario(jnp.float64)
    return params._replace(
        gait=params.gait._replace(n_steps=jnp.asarray(0.0, jnp.float64)),
        mpc_weights=mpc.MPCWeights(Q=jnp.asarray(Q_STAND, jnp.float64),
                                   R=jnp.full((12,), R_STAND, jnp.float64)))


def record(ticks: int) -> dict:
    loop = MujocoLoop(load_robot("g1_23dof", dtype=jnp.float64), params=standing_params())
    out = {k: [] for k in ("qpos", "qvel", "tau", "com", "fz")}
    for _ in range(ticks):
        out["qpos"].append(loop.mj_data.qpos.copy())
        out["qvel"].append(loop.mj_data.qvel.copy())
        log = loop.run(1)
        for k in ("tau", "com", "fz"):
            out[k].append(log[k][0])
    trace = {k: np.stack(v) for k, v in out.items()}
    trace["qpos_end"], trace["qvel_end"] = loop.mj_data.qpos.copy(), loop.mj_data.qvel.copy()
    return trace


def compare_eager(trace: dict, ticks: int) -> None:
    """The JAX loop's eager ticks on the recorded measurements against the
    recorded (jitted) torques."""
    loop = MujocoLoop(load_robot("g1_23dof", dtype=jnp.float64), params=standing_params())
    with jax.disable_jit():
        for t in range(ticks):
            loop.mj_data.qpos[:], loop.mj_data.qvel[:] = trace["qpos"][t], trace["qvel"][t]
            tau = loop.run(1)["tau"][0]
            print(f"tick {t}: eager against jitted max |dtau| "
                  f"{np.abs(tau - trace['tau'][t]).max():.3e} N m", flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ticks", type=int, default=200)
    p.add_argument("--compare-eager", type=int, default=0, metavar="N")
    args = p.parse_args()
    trace = record(args.ticks)
    np.savez_compressed(OUT, **trace)
    print(f"{OUT}: {args.ticks} ticks, {OUT.stat().st_size} bytes; "
          + ", ".join(f"{k} {v.shape}" for k, v in trace.items()))
    if args.compare_eager:
        compare_eager(trace, args.compare_eager)


if __name__ == "__main__":
    main()
