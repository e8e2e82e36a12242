"""Where the WBID's float32 pri_res of a variant cascade comes from: the JAX
package and the PyTorch port on the CPU, on the period that chip_smoke.py's
phase 13 drives (one default ``EngineConfig`` period with the variant's
torso / hand tasks, ``variant_walking_scenario``, from ``init_state``).

    JAX_PLATFORMS=cpu python tools/wbid_f32_cross.py [VARIANT ...]

VARIANT is ``g1_29dof`` or ``g1_29dof_with_hand`` (both when none is named).
Each package's period records its 40 WBID QPs (H, g, C, l, u) at float32.
Then each package's ``solve_qp`` solves both packages' QPs at float32, and
the port's also at float64, so that a difference in the period's pri_res
splits into its QP data and its solver's rounding. The polish's
acceptances are counted in both packages on their own QPs: the rounds, of
``polish_rounds`` per solve, whose candidate each package keeps (its KKT
residual improved). Prints one JSON line: per variant the largest and the
median pri_res of each (solver, QP data) pair and the acceptances. A few
minutes a variant, most of them the JAX period's XLA compile.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from g1_locomotion_tpu.engine import tick as jeng  # noqa: E402
from g1_locomotion_tpu.models.robot import load_robot as jload  # noqa: E402
from g1_locomotion_tpu.ops import qp as jqp  # noqa: E402
from g1_locomotion_tpu_torch import convert  # noqa: E402
from g1_locomotion_tpu_torch.engine import tick as teng  # noqa: E402
from g1_locomotion_tpu_torch.models import robot as trb  # noqa: E402
from g1_locomotion_tpu_torch.ops import qp as tqp  # noqa: E402

CPU = torch.device("cpu")
MPC_N = 120  # the MPC's QP width: its solves are not the WBID's


def record(variant: str):
    """Both packages' WBID QPs of the period and their polish inputs, as
    numpy: ({"jax": [...], "port": [...]}, the QP configs (JAX, port))."""
    qps = {"jax": [], "port": []}
    polish = {"jax": [], "port": []}
    j_solve, t_solve, j_polish, t_polish = jqp.solve_qp, tqp.solve_qp, jqp._polish, tqp._polish

    def j_solve_rec(P, q, A, l, u, cfg=jqp.QPConfig(), x0=None, y0=None):
        if P.shape[-1] != MPC_N:
            jax.debug.callback(lambda *a: qps["jax"].append([np.asarray(t) for t in a]),
                               P, q, A, l, u)
        return j_solve(P, q, A, l, u, cfg, x0=x0, y0=y0)

    def t_solve_rec(P, q, A, l, u, cfg=tqp.QPConfig(), x0=None, y0=None):
        if P.shape[-1] != MPC_N:
            qps["port"].append([t[0].numpy() for t in (P, q, A, l, u)])
        return t_solve(P, q, A, l, u, cfg, x0, y0)

    def j_polish_rec(P, q, A, l, u, x, y, cfg, rounds=3):
        if P.shape[-1] != MPC_N:
            jax.debug.callback(lambda *a: polish["jax"].append([np.asarray(t) for t in a]),
                               P, q, A, l, u, x, y)
        return j_polish(P, q, A, l, u, x, y, cfg, rounds)

    def t_polish_rec(P, q, A, l, u, x, y, cfg, rounds=3):
        if P.shape[-1] != MPC_N:
            polish["port"].append([t[0].numpy() for t in (P, q, A, l, u, x, y)])
        return t_polish(P, q, A, l, u, x, y, cfg, rounds)

    jm = jload(variant, dtype=jnp.float32)
    vcfg = jeng.variant_walking_config(jm)
    cfg = jeng.EngineConfig()._replace(torso_task=vcfg.torso_task, hand_task=vcfg.hand_task)
    tm = trb.load_robot(variant, device=CPU, dtype=torch.float32)
    tcfg = convert.engine_config(cfg._asdict())
    jqp.solve_qp, tqp.solve_qp, jqp._polish, tqp._polish = (j_solve_rec, t_solve_rec,
                                                            j_polish_rec, t_polish_rec)
    try:
        rollout = jeng.make_rollout(jm, cfg)
        params = jeng.variant_walking_scenario(jm, jnp.float32)
        jax.block_until_ready(jax.jit(lambda s: rollout(s, params, 1))(
            jeng.init_state(jm, cfg, jnp.float32)))
        teng.ControlLoop(tm, tcfg).period(teng.init_state(tm, tcfg, 1, torch.float32),
                                          teng.variant_walking_scenario(tm, dtype=torch.float32))
    finally:
        jqp.solve_qp, tqp.solve_qp, jqp._polish, tqp._polish = (j_solve, t_solve, j_polish,
                                                                t_polish)
    return qps, polish, (cfg.wbid.qp, tcfg.wbid.qp)


def squeeze(a: np.ndarray) -> np.ndarray:
    """An instance without the batch axes the recording may carry."""
    while a.ndim > 1 and a.shape[0] == 1:
        a = a[0]
    return a


def main(argv) -> None:
    variants = argv or ["g1_29dof", "g1_29dof_with_hand"]
    out = {"platform": jax.devices()[0].platform}
    for variant in variants:
        qps, polish, (jcfg, tcfg) = record(variant)
        j_pri = jax.jit(lambda *a: jqp.solve_qp(*a, jcfg).pri_res)

        def jax_pri(qp):
            return float(j_pri(*(jnp.asarray(squeeze(a), jnp.float32) for a in qp)))

        def port_pri(qp, dtype):
            return float(tqp.solve_qp(*(torch.as_tensor(squeeze(a), dtype=dtype)[None]
                                        for a in qp), tcfg).pri_res[0])

        pri = {}
        for data in ("jax", "port"):
            pri[f"jax solver, {data} QPs, f32"] = [jax_pri(qp) for qp in qps[data]]
            pri[f"port solver, {data} QPs, f32"] = [port_pri(qp, torch.float32)
                                                    for qp in qps[data]]
            pri[f"port solver, {data} QPs, f64"] = [port_pri(qp, torch.float64)
                                                    for qp in qps[data]]

        def accepted(run, args):
            """How many of the rounds kept their candidate: x after r rounds
            against x after r - 1."""
            xs = [run(args, r) for r in range(jcfg.polish_rounds + 1)]
            return sum(int(not np.array_equal(a, b)) for a, b in zip(xs, xs[1:]))

        def j_run(args, rounds):
            a = [jnp.asarray(squeeze(t)) for t in args]
            return a[5] if rounds == 0 else np.asarray(jqp._polish(*a, jcfg, rounds)[0])

        def t_run(args, rounds):
            a = [torch.as_tensor(squeeze(t))[None] for t in args]
            return (a[5] if rounds == 0 else tqp._polish(*a, tcfg, rounds)[0])[0].numpy()

        out[variant] = {
            "solves": {k: len(v) for k, v in qps.items()},
            "pri_res_max": {k: max(v) for k, v in pri.items()},
            "pri_res_median": {k: float(np.median(v)) for k, v in pri.items()},
            "polish_rounds_accepted": {
                "jax": sum(accepted(j_run, a) for a in polish["jax"]),
                "port": sum(accepted(t_run, a) for a in polish["port"]),
                "of": jcfg.polish_rounds * len(polish["jax"])},
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
