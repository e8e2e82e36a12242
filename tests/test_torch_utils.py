"""utils/checkpoint.py, utils/stats.py and utils/tree.py of the PyTorch
port, on the CPU (the port's version of ``tests/test_compat_api.py:82-103``,
and the checks of the reference's ``checkpoint.restore``: leaf count,
structure and every leaf's shape)."""

import json

import pytest
import torch

from g1_locomotion_tpu_torch.engine import tick as teng
from g1_locomotion_tpu_torch.models.robot import load_robot
from g1_locomotion_tpu_torch.parallel import mesh, sweep
from g1_locomotion_tpu_torch.utils import checkpoint, tree
from g1_locomotion_tpu_torch.utils.stats import StatisticsRegistry, throughput

CPU = torch.device("cpu")


def test_checkpoint_roundtrip(tmp_path):
    state = {"a": torch.arange(5.0), "b": (torch.ones((2, 2)), torch.tensor(3))}
    p = str(tmp_path / "ckpt")
    checkpoint.save(p, state, meta={"step": 7})
    assert checkpoint.exists(p)
    restored, meta = checkpoint.restore(p, state)
    assert meta["step"] == 7
    torch.testing.assert_close(restored["a"], torch.arange(5.0), rtol=0, atol=0)
    torch.testing.assert_close(restored["b"][0], torch.ones((2, 2)), rtol=0, atol=0)
    assert restored["b"][1].dtype == torch.int64 and int(restored["b"][1]) == 3


def test_checkpoint_engine_state_and_stats(tmp_path):
    """The sweep's checkpoint (engine states, SweepStats, the drift origin,
    the lowest heights) round-trips exactly, each leaf cast to the
    template's dtype."""
    model = load_robot("g1_23dof", device=CPU, dtype=torch.float64)
    states = teng.init_state(model, teng.EngineConfig(), 3, torch.float64)
    zero = torch.zeros((), dtype=torch.float64)
    stats = sweep.SweepStats(n=zero + 3, com_drift_sum=zero + 0.5, tau_max=zero + 20.0,
                             fell_count=zero)
    saved = (states, stats, torch.rand((3, 3), dtype=torch.float64), torch.rand(3))
    p = str(tmp_path / "sweep")
    checkpoint.save(p, saved, meta={"chunk": 1})
    like = tree.map_leaves(lambda x: torch.zeros_like(x, dtype=torch.float32), saved)
    back, meta = checkpoint.restore(p, like)
    assert meta == {"chunk": 1} and type(back[0]) is teng.EngineState
    for a, b in zip(tree.leaves(back), tree.leaves(saved)):
        assert a.dtype == torch.float32 and torch.equal(a, b.float())


@pytest.mark.parametrize("case", ["leaf count", "structure", "shape"])
def test_checkpoint_mismatch_raises(tmp_path, case):
    state = {"a": torch.arange(5.0), "b": (torch.ones((2, 2)), torch.tensor(3))}
    p = str(tmp_path / "ckpt")
    checkpoint.save(p, state)
    like = {
        "leaf count": {"a": torch.arange(5.0), "b": (torch.ones((2, 2)),)},
        "structure": {"a": torch.arange(5.0), "c": (torch.ones((2, 2)), torch.tensor(3))},
        "shape": {"a": torch.arange(4.0), "b": (torch.ones((2, 2)), torch.tensor(3))},
    }[case]
    match = {"leaf count": "leaves", "structure": "structure", "shape": "shape"}[case]
    with pytest.raises(ValueError, match=match):
        checkpoint.restore(p, like)
    manifest = json.loads((tmp_path / "ckpt.json").read_text())
    assert manifest["n_leaves"] == 3


def test_stats_registry():
    reg = StatisticsRegistry("/wbid_statistics")
    reg.set("wbid_solve_time", 0.0012)
    t = reg.timer("solve")
    for _ in range(3):
        out = t.time(lambda: torch.ones(8).sum())
    assert float(out) == 8.0
    data = json.loads(reg.export())
    assert data["topic"] == "/wbid_statistics" and data["scalars"] == {"wbid_solve_time": 0.0012}
    assert set(data["timers"][0]) == {"name", "n", "mean_ms", "p50_ms", "p99_ms", "min_ms",
                                      "max_ms"}
    assert data["timers"][0]["n"] == 3
    assert reg.timer("empty").summary() == {"name": "empty", "n": 0}
    assert throughput(10, 2.0) == 5.0 and throughput(10, 0.0) == float("inf")


def test_tree_structure_and_rows():
    t = {"x": (torch.ones(2), None), "a": [torch.zeros(1)]}
    assert tree.structure(t) == "{'a': [*], 'x': (*, None,)}"
    assert [tuple(x.shape) for x in tree.leaves(t)] == [(1,), (2,)]
    # Contiguous rows per process, the first B % world one row longer.
    assert [mesh.row_slice(10, r, 3) for r in range(3)] == [slice(0, 4), slice(4, 7),
                                                             slice(7, 10)]
    params = sweep.randomize(sweep.SweepSpec(n_scenarios=5), torch.Generator().manual_seed(0),
                             teng.default_scenario(device=CPU, dtype=torch.float64))
    rows = mesh.shard_rows(params, 1, 2)
    assert rows.batch() == 2 and torch.equal(rows.v_cmd, params.v_cmd[3:5])
    assert rows.srbd.inertia.shape == (2, 3, 3) and rows.mpc_weights.Q.shape == (13,)
    # One process: the statistics' reduction is the identity.
    stats = sweep.SweepStats(*(torch.tensor(float(i)) for i in range(4)))
    assert mesh.all_reduce_stats(stats, sweep.REDUCE_OPS) is stats
