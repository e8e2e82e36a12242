"""A run with the timed path broken underneath comes out not correct: for
each cell, the faults that cell can have (a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced, the body's integrated velocity off by 0.05 m/s; no cell spans
chips, so no exchange can be left out). The run is
the harness's own (``run.run_cell``) past its look for a card, on the CPU at
a small batch, against each cell's committed limits."""

import pytest
import torch

from benchmark import run
from benchmark.harness import manifest

SEED = 2**32 + 77


def serving_fault(monkeypatch, fault):
    from g1_locomotion_tpu_torch.engine import mujoco_bridge

    step = mujoco_bridge.BridgeController.step

    def broken(self, qpos, qvel):
        before = self.state
        tau, log = step(self, qpos, qvel)
        if fault == "unchanged":
            self.state = before
        elif fault == "altered":
            tau = tau + 1.0
        return tau, log
    monkeypatch.setattr(mujoco_bridge.BridgeController, "step", broken)


def sweep_fault(monkeypatch, fault):
    from g1_locomotion_tpu_torch.engine import tick as eng
    from g1_locomotion_tpu_torch.parallel import sweep

    run_sweep = sweep.run_sweep

    def broken(loop, params, n, states0=None, com_ref=None):
        B = params.batch()
        if fault == "half":
            half = slice(0, B // 2)
            part = eng.EngineState(*(f[half] for f in states0))
            out, (com, z), stats = run_sweep(loop, params.rows(half), n, states0=part)
            state = eng.EngineState(*(torch.cat([o, s[B // 2:]]) for o, s in zip(out, states0)))
            return state, (torch.cat([com, com]), torch.cat([z, z])), stats
        state, extra, stats = run_sweep(loop, params, n, states0=states0)
        if fault == "unchanged":
            state = states0
        elif fault == "altered":
            state = state._replace(u0=state.u0 + 10.0)
        elif fault == "drift":
            v = state.v.clone()
            v[:, 0:3] += 0.05
            state = state._replace(v=v)
        return state, extra, stats
    monkeypatch.setattr(sweep, "run_sweep", broken)


def srbd_fault(monkeypatch, fault):
    from g1_locomotion_tpu_torch.mpc import srbd_loop

    period = srbd_loop.SRBDLoop.period

    def broken(self, state, params, kick=None):
        B = state.x.shape[0]
        if fault == "half":
            half = slice(0, B // 2)
            p_half = params.rows(half)
            part = srbd_loop.SRBDLoopState(*(f[half] for f in state))
            out, log = period(self, part, p_half, None if kick is None else kick[half])
            full = srbd_loop.SRBDLoopState(*(torch.cat([o, s[B // 2:]])
                                             for o, s in zip(out, state)))
            log = log._replace(u0=torch.cat([log.u0, torch.zeros_like(log.u0)]))
            return full, log
        out, log = period(self, state, params, kick)
        if fault == "unchanged":
            out = state
        elif fault == "altered":
            log = log._replace(u0=log.u0 + 10.0)
        elif fault == "drift":
            x = out.x.clone()
            x[:, 9:12] += 0.05
            out = out._replace(x=x)
        return out, log
    monkeypatch.setattr(srbd_loop.SRBDLoop, "period", broken)


CASES = [
    ("serving_b1", 1, 3.0, serving_fault, "unchanged"),
    ("serving_b1", 1, 3.0, serving_fault, "altered"),
    ("sweep_4096", 4, 0.1, sweep_fault, "unchanged"),
    ("sweep_4096", 4, 0.1, sweep_fault, "half"),
    ("sweep_4096", 4, 0.1, sweep_fault, "altered"),
    ("sweep_4096", 4, 0.1, sweep_fault, "drift"),
    ("srbd_gait_4096", 16, 1.0, srbd_fault, "unchanged"),
    ("srbd_gait_4096", 16, 1.0, srbd_fault, "half"),
    ("srbd_gait_4096", 16, 1.0, srbd_fault, "altered"),
    ("srbd_gait_4096", 16, 1.0, srbd_fault, "drift"),
]


def small_cell(name, batch):
    cell = manifest.resolve(name)
    return cell._replace(config=dict(cell.config, batch=batch, check_units={
        k: min(4, v) for k, v in cell.config["check_units"].items()}))


@pytest.mark.parametrize("name,batch,seconds,inject,fault", CASES,
                         ids=[f"{c[0]}-{c[4]}" for c in CASES])
def test_fault_is_not_correct(monkeypatch, name, batch, seconds, inject, fault):
    torch.set_num_threads(2)
    inject(monkeypatch, fault)
    result = run.run_cell(small_cell(name, batch), SEED, seconds, False, "cpu", warm=False)
    assert result["attempted"] > 0
    assert not result["correct"], result["checks"]
