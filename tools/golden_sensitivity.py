"""How far the JAX package's own validated walk moves from its golden when
its initial state moves by a rounding-level amount.

    JAX_PLATFORMS=cpu python tools/golden_sensitivity.py

Rolls out ``walking_config()`` / ``walking_scenario(float64, 8 steps,
v_cmd = (0.1, 0))`` for the golden's 100 periods, jitted, from
``init_state`` with the base's x moved by 0, 1e-15 and 1e-12 m, and prints
per quantity (CoM, tau, WBID forces) the largest deviation from
``tests/goldens/walk_golden.npz`` and the first tick beyond
``tests/test_golden.py``'s tolerances; and whether the contact sequence is
the golden's. A yardstick for any other implementation's distance from the
golden (the PyTorch port's: tests/test_torch_golden.py).
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from g1_locomotion_tpu.engine import tick as eng  # noqa: E402
from g1_locomotion_tpu.models.robot import load_robot  # noqa: E402

GOLDEN = Path(__file__).resolve().parent.parent / "tests" / "goldens" / "walk_golden.npz"
TOL = {"com": 1e-4, "tau": 5e-2, "forces": 5e-1}  # tests/test_golden.py
PERIODS = 100


def main():
    g1 = load_robot("g1_23dof", dtype=jnp.float64)
    cfg = eng.walking_config()
    params = eng.walking_scenario(jnp.float64, n_steps=8.0, v_cmd=(0.1, 0.0))
    rollout = eng.make_rollout(g1, cfg)
    run = jax.jit(lambda s: rollout(s, params, PERIODS))
    n = PERIODS * cfg.ticks_per_mpc
    with np.load(GOLDEN) as z:
        golden = {k: z[k].reshape(n, -1) for k in ("com", "tau", "forces", "contact")}
    for eps in (0.0, 1e-15, 1e-12):
        state = eng.init_state(g1, cfg, jnp.float64)
        _, logs = run(state._replace(q=state.q.at[0].add(eps)))
        got = {k: np.asarray(getattr(logs, k)).reshape(n, -1) for k in golden}
        parts = []
        for k, tol in TOL.items():
            err = np.abs(got[k] - golden[k]).max(axis=1)
            first = np.flatnonzero(err > tol)
            parts.append(f"{k} max {err.max():.3e}, first tick over {first[0] if first.size else None}")
        print(f"base x + {eps:g} m: contacts equal {np.array_equal(got['contact'], golden['contact'])}; "
              + "; ".join(parts), flush=True)


if __name__ == "__main__":
    main()
