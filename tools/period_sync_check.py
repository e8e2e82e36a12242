"""Which operations of a control period make the host wait for the card.

    python3 tools/period_sync_check.py

On one CUDA card, one period of each of the three control-period
configurations that chip_smoke.py drives (serving B = 1, the default
configuration at B = 64, ``walking_config`` at float64, B = 1) and of the
SRBD loop's two (``MPCConfig()`` at B = 64 with a kick, its serving chain
at B = 1), the serving period with ``EngineConfig.telemetry`` (CUDA events
around its stages) and one period of ``parallel/sweep.run_sweep`` over a
randomized batch of 64 (per-instance mass, inertia and mu; the statistics'
reduction), and one period (40 ticks) of the MuJoCo bridge's controller at
float64 on the recorded trace (``tests/torch_mujoco_trace.npz``; its one
inherent sync a tick is tau's copy to the host, for MuJoCo), under
``torch.cuda.set_sync_debug_mode("warn")``: every operation
that synchronizes the host with the card warns, and this prints, per
configuration, how many warnings each line of this repository's code that
led to one gave. A period with none can be captured as one CUDA graph.
Needs a card; raises without one.
"""

from __future__ import annotations

import collections
import sys
import traceback
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from g1_locomotion_tpu_torch._device import require_cuda  # noqa: E402
from g1_locomotion_tpu_torch.engine import tick as eng  # noqa: E402
from g1_locomotion_tpu_torch.engine.mujoco_bridge import BridgeController  # noqa: E402
from g1_locomotion_tpu_torch.models.robot import load_robot  # noqa: E402
from g1_locomotion_tpu_torch.mpc import srbd_loop as sl  # noqa: E402
from g1_locomotion_tpu_torch.mpc.solver import MPCConfig  # noqa: E402
from g1_locomotion_tpu_torch.parallel import sweep  # noqa: E402


def serving(cfg):
    return cfg._replace(
        mpc=cfg.mpc._replace(qp=cfg.mpc.qp._replace(polish_kernel=True)),
        wbid=cfg.wbid._replace(qp=cfg.wbid.qp._replace(polish_kernel=True), fast_stack=True))


def control_period(cfg, batch, dtype, params_fn, device):
    """(one period of engine.tick.ControlLoop, its initial state)."""
    model = load_robot("g1_23dof", device=device, dtype=dtype)
    loop = eng.ControlLoop(model, cfg)
    params = params_fn(device=device, dtype=dtype)
    return (lambda state: loop.period(state, params)), eng.init_state(model, cfg, batch, dtype)


def srbd_period(cfg, batch, device):
    """(one period of mpc/srbd_loop.SRBDLoop at float32 with a lateral kick,
    its initial state)."""
    loop = sl.SRBDLoop(cfg)
    params = eng.walking_scenario(device=device, dtype=torch.float32)
    kick = torch.tensor([0.0, 0.1, 0.0], device=device).expand(batch, 3)
    state = sl.init_loop_state(cfg, 0.598, batch=batch, device=device, dtype=torch.float32)
    return (lambda s: loop.period(s, params, kick)), state


def sweep_period(batch, device):
    """(one period of parallel/sweep.run_sweep over a randomized batch in the
    default configuration, its initial state)."""
    model = load_robot("g1_23dof", device=device, dtype=torch.float32)
    loop = eng.ControlLoop(model, eng.EngineConfig())
    params = sweep.randomize(sweep.SweepSpec(n_scenarios=batch), torch.Generator().manual_seed(0),
                             eng.default_scenario(device=device, dtype=torch.float32))

    def period(state):
        final, _, stats = sweep.run_sweep(loop, params, 1, states0=state)
        return final, stats

    return period, eng.init_state(model, loop.cfg, batch, torch.float32)


def bridge_period(device):
    """(40 ticks of the MuJoCo bridge's controller at float64 on the recorded
    trace's measurements, the settled start)."""
    trace = np.load(REPO / "tests" / "torch_mujoco_trace.npz")
    model = load_robot("g1_23dof", device=device, dtype=torch.float64)
    ctrl = BridgeController(model, params=eng.mujoco_standing_scenario(device=device,
                                                                        dtype=torch.float64))
    ctrl.reset(trace["qpos"][0], trace["qvel"][0])

    def period(start):
        ctrl.state, ctrl.tick = start
        for t in range(40):
            ctrl.step(trace["qpos"][t], trace["qvel"][t])
        return (ctrl.state, ctrl.tick), None

    return period, (ctrl.state, 0)


def check(label, period, state):
    state, _ = period(state)  # warm: first-use allocations and builds
    torch.cuda.synchronize()
    counts = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            # The innermost frame of this repository's code that led there;
            # without one, the innermost frames of the stack.
            stack = traceback.extract_stack()[:-1]
            frames = [f for f in stack
                      if f.filename.startswith(str(REPO)) and f.filename != __file__]
            where = frames[-1] if frames else None
            counts[f"{Path(where.filename).relative_to(REPO)}:{where.lineno}" if where
                   else f"{Path(filename).name}:{lineno} (no frame of the package; stack: "
                   + " <- ".join(f"{Path(f.filename).name}:{f.lineno} {f.name}"
                                 for f in reversed(stack[-6:])) + ")"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        # Switched on before the hook: the first switch in a process warns
        # once that the mode is a prototype ("... synchronizing operations"),
        # which is no sync of the period.
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = record
        try:
            period(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    total = sum(counts.values())
    print(f"{label}: {total} synchronizing operations in one period"
          + ("" if not counts else ": " + ", ".join(f"{k} x{n}" for k, n in counts.most_common())))


def main():
    device = require_cuda()
    check("serving (B = 1, f32)", *control_period(serving(eng.EngineConfig()), 1,
                                                  torch.float32, eng.default_scenario, device))
    check("default (B = 64, f32)", *control_period(eng.EngineConfig(), 64, torch.float32,
                                                   eng.default_scenario, device))
    check("walking_config (B = 1, f64)", *control_period(eng.walking_config(), 1, torch.float64,
                                                         eng.walking_scenario, device))
    mcfg = MPCConfig()
    check("SRBD loop (B = 64, f32)", *srbd_period(mcfg, 64, device))
    check("SRBD loop serving (B = 1, f32)", *srbd_period(
        mcfg._replace(qp=mcfg.qp._replace(polish_kernel=True)), 1, device))
    check("serving with telemetry (B = 1, f32)", *control_period(
        serving(eng.EngineConfig(telemetry=True)), 1, torch.float32, eng.default_scenario,
        device))
    check("sweep period (B = 64, f32)", *sweep_period(64, device))
    check("MuJoCo bridge controller, 40 ticks (B = 1, f64)", *bridge_period(device))


if __name__ == "__main__":
    main()
