"""The JAX package's control period at float32 on the CPU, on the chains that
chip_smoke.py's phases 7 and 8 drive the PyTorch port through: the largest
value of each period invariant it gives there. chip_smoke.py holds the port
to twice these (PERIOD_BOUNDS).

    JAX_PLATFORMS=cpu python tools/period_invariant_bounds.py

* serving (phase 7): 25 periods (1.0 s: the stand, the first double support
  and the first swing) from ``init_state`` in the serving configuration of
  ``tools/bench_tick_p99.py`` (``polish_kernel`` on both QPs, ``fast_stack``;
  the Pallas kernels in interpret mode), ``default_scenario``, B = 1;
* batched (phase 8): one period of the default ``EngineConfig`` from
  ``init_state``, ``default_scenario``; ``tools/bench_cascade.py`` broadcasts
  that one instance to B = 2048, so one instance gives the batch's maxima.

The invariants (``chip_smoke.period_maxima``): MPC and WBID pri_res, the
largest force on a swinging foot's contacts, the largest deviation of the
summed normal force from m g in double support, the base's tilt from
upright, |tau| beyond tau_max, non-finite values. Prints one JSON line, a
few minutes (the default configuration's XLA compile takes most of it).
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
from g1_locomotion_tpu.ops import pallas_lin  # noqa: E402

F32 = jnp.float32


def serving(cfg):
    return cfg._replace(
        mpc=cfg.mpc._replace(qp=cfg.mpc.qp._replace(polish_kernel=True)),
        wbid=cfg.wbid._replace(qp=cfg.wbid.qp._replace(polish_kernel=True), fast_stack=True))


def chain_maxima(model, cfg, periods: int) -> dict:
    cfg = cfg._replace(log_q=True)
    params = eng.default_scenario(F32)
    rollout = eng.make_rollout(model, cfg)
    gj, gji, admm = pallas_lin.gj_solve, pallas_lin.gj_inverse, pallas_lin.admm_iterate
    with mock.patch.object(pallas_lin, "gj_solve", lambda K, b: gj(K, b, interpret=True)), \
            mock.patch.object(pallas_lin, "gj_inverse", lambda K: gji(K, interpret=True)), \
            mock.patch.object(pallas_lin, "admm_iterate",
                              lambda *a, **kw: admm(*a, **kw, interpret=True)):
        _, log = jax.jit(lambda s: rollout(s, params, periods))(eng.init_state(model, cfg, F32))
    log = {k: np.asarray(v) for k, v in log._asdict().items()}
    mg = float(np.asarray(jnp.sum(model.mass))) * 9.80665
    return cs.period_maxima(log, np.asarray(model.tau_max), mg)


def main():
    model = load_robot("g1_23dof", dtype=F32)
    out = {
        "platform": jax.devices()[0].platform, "dtype": "float32",
        "serving": chain_maxima(model, serving(eng.EngineConfig()), cs.SERVING_PERIODS),
        "batched": chain_maxima(model, eng.EngineConfig(), 1),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
