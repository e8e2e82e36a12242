"""EngineConfig.telemetry of the PyTorch port: the period's MPC solve time
and each tick's WBID solve time in TickLog.mpc_ms / wbid_ms (the port's
version of ``tests/test_telemetry.py``, on the CPU at float64, where the
host clock times the stages; on the card CUDA events do, checked by
``chip_smoke.py`` phase 16)."""

import torch

from g1_locomotion_tpu_torch import convert
from g1_locomotion_tpu_torch.engine import tick as teng
from g1_locomotion_tpu_torch.models.robot import load_robot
from test_torch_sweep import tiny_cfg

CPU = torch.device("cpu")
F64 = torch.float64


def _rollout(telemetry: bool, periods: int):
    model = load_robot("g1_23dof", device=CPU, dtype=F64)
    cfg = convert.engine_config(tiny_cfg(telemetry)._asdict())
    params = teng.default_scenario(device=CPU, dtype=F64)
    params = params._replace(gait=params.gait._replace(n_steps=torch.tensor(0.0, dtype=F64)))
    loop = teng.ControlLoop(model, cfg)
    return loop.rollout(teng.init_state(model, cfg, 1, F64), params, periods)[1]


def test_telemetry_records_stage_times():
    logs = _rollout(True, 3)
    mpc_ms, wbid_ms = logs.mpc_ms[0], logs.wbid_ms[0]  # (3, 4)
    assert mpc_ms.shape == wbid_ms.shape == (3, 4) and mpc_ms.dtype == F64
    # Every period records one MPC solve time (on each of its ticks) and
    # every tick its own WBID solve time: all positive, all sane (< 60 s).
    assert bool((mpc_ms > 0).all()), mpc_ms
    assert bool((wbid_ms > 0).all()), wbid_ms
    assert float(mpc_ms.max()) < 60e3 and float(wbid_ms.max()) < 60e3
    assert torch.equal(mpc_ms, mpc_ms[:, :1].expand(3, 4))


def test_telemetry_off_is_zero():
    logs = _rollout(False, 1)
    assert float(logs.mpc_ms.abs().max()) == 0.0
    assert float(logs.wbid_ms.abs().max()) == 0.0
