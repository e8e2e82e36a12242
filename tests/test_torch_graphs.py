"""engine/tick.py's CUDA graphs: each stage (the MPC stage, the tick) split
into pre / solve / post, captured once per key and replayed.

The CPU tests (tier-1) run the split stages against the whole stage, the
tick's phase as a tensor against the two numbers, and the graph bookkeeping
(keys, static inputs, outputs handed back, launch counts, a failed capture)
with a stand-in for ``torch.cuda.CUDAGraph`` that has a graph's semantics on
the CPU: the capture's outputs are the tensors every replay writes into.

The tests marked ``gpu`` run the real graphs on the card against the eager
path, and skip without a CUDA device. The file imports torch and numpy only
(the machine with the card has no JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_graphs.py -q
"""

import numpy as np
import pytest
import torch

from g1_locomotion_tpu_torch.engine import tick as eng
from g1_locomotion_tpu_torch.engine.mujoco_bridge import BridgeController
from g1_locomotion_tpu_torch.models.robot import load_robot
from g1_locomotion_tpu_torch.mpc.solver import MPCConfig
from g1_locomotion_tpu_torch.ops import cuda_lin
from g1_locomotion_tpu_torch.parallel.sweep import SweepSpec, randomize
from g1_locomotion_tpu_torch.utils import tree
from g1_locomotion_tpu_torch.wbid.solver import WBIDConfig

F64 = torch.float64


def _serving() -> eng.EngineConfig:
    """The serving configuration: B2-B4 in both QPs, the fast stack."""
    return eng.EngineConfig(
        mpc=MPCConfig(qp=MPCConfig().qp._replace(polish_kernel=True)),
        wbid=WBIDConfig(qp=WBIDConfig().qp._replace(polish_kernel=True), fast_stack=True))


def _short_wbid() -> eng.EngineConfig:
    """EngineConfig() with a short WBID QP: the tick's phase is under test,
    not the solver."""
    qp = WBIDConfig().qp._replace(iters=10, rho_segments=1, polish_rounds=1)
    return eng.EngineConfig(wbid=WBIDConfig(qp=qp))


CONFIGS = {"serving": (_serving, 1), "default": (eng.EngineConfig, 2)}


def _equal(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _copy(t):
    return tree.map_leaves(torch.clone, t)


def _eager_stage(loop, name, params, *args):
    """Stage `name` of `loop` run eagerly, whatever graphs the loop holds."""
    return eng._eager([getattr(loop, s) for s in eng._SEGMENTS[name]], params, args, None)


@pytest.fixture(scope="module")
def g1_cpu():
    return load_robot("g1_23dof", device="cpu", dtype=F64)


def _walking_start(model, cfg, batch, dtype, device=None):
    """(params, a state 0.6 s into the walk with an MPC solve applied): a
    swing in progress, so every branch of the tick has work."""
    params = eng.walking_scenario(device=device or model.device, dtype=dtype)
    state = eng.init_state(model, cfg, batch, dtype)
    state = state._replace(t=state.t + 0.6, gait_clock=state.gait_clock + 0.6)
    return params, state


class _Graph:
    """A CUDA graph's semantics on the CPU: the capture runs fn once for its
    outputs' tensors, and each replay runs fn again and writes the results
    into those same tensors."""

    def __init__(self, fn):
        self.fn = fn
        self.out = fn()

    def replay(self):
        for dst, src in zip(tree.leaves(self.out), tree.leaves(self.fn())):
            dst.copy_(src)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Let the loop capture on the CPU, with _Graph for the CUDA graph;
    returns the list of captures made."""
    made = []

    def capture(fn, pool, stream):
        graph = _Graph(fn)
        made.append(graph)
        return graph, graph.out

    monkeypatch.setattr(eng, "_graphable", lambda device: True)
    monkeypatch.setattr(eng, "_new_pool", lambda device: (None, None))
    monkeypatch.setattr(eng, "_capture_graph", capture)
    return made


# ---------------------------------------------------------------------------
# CPU (tier-1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_split_segments_compose_to_the_stage(g1_cpu, config):
    """pre -> solve -> post on copies of the inputs (as a capture runs them)
    equal the whole stage, for the MPC stage and a tick, at f64."""
    make, batch = CONFIGS[config]
    loop = eng.ControlLoop(g1_cpu, make())
    params, state = _walking_start(g1_cpu, loop.cfg, batch, F64)

    mid = loop._mpc_pre(params, _copy(state))
    sol = loop._mpc_solve(params, _copy(state), mid)
    split = loop._mpc_post(params, _copy(state), mid, sol)
    whole = loop._mpc_stage(params, state)
    assert _equal(split, whole)

    state = whole[0]
    alpha = loop._alpha(5, F64)
    pre = loop._tick_pre(params, _copy(state), alpha)
    assert all(isinstance(x, torch.Tensor) for x in tree.leaves(pre))
    sol = loop._tick_solve(params, _copy(state), alpha, pre)
    split = loop._tick_post(params, _copy(state), alpha, pre, sol)
    assert _equal(split, loop._tick(params, state, alpha))


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_tensor_phase_equals_numbers(g1_cpu, dtype):
    """_tick with alpha a (2,) tensor of the state's dtype equals _tick with
    the two numbers, bit for bit, at every phase of the period."""
    model = g1_cpu.to(dtype=dtype)
    loop = eng.ControlLoop(model, _short_wbid())
    params, state = _walking_start(model, loop.cfg, 1, dtype)
    state, _ = loop._mpc_stage(params, state)
    for i in range(loop.cfg.ticks_per_mpc):
        alpha = loop._alpha(i, dtype)
        numbers = loop._tick(params, state, alpha)
        tensor = loop._tick(params, state, torch.tensor(alpha, dtype=dtype))
        assert _equal(numbers, tensor), i


def test_cpu_runs_every_segment_eagerly(g1_cpu):
    loop = eng.ControlLoop(g1_cpu, _short_wbid())
    params, state = _walking_start(g1_cpu, loop.cfg, 1, F64)
    state, _ = loop._mpc_stage(params, state)
    loop._tick(params, state, loop._alpha(0, F64))
    assert loop.graph_counts() == {"captured": 0, "replayed": 0, "eager": 6}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_graph_bookkeeping_equals_eager(g1_cpu, cpu_graphs, config):
    """The graph path (static inputs, segments chained through the
    capture's outputs, outputs handed back) equals the eager stages over an
    MPC stage and ticks; one capture per segment and key, then replays."""
    make, batch = CONFIGS[config]
    graphed = eng.ControlLoop(g1_cpu, make())
    eager = eng.ControlLoop(g1_cpu, make())
    params, state = _walking_start(g1_cpu, graphed.cfg, batch, F64)

    def run_eager(name, *args):
        return _eager_stage(eager, name, params, *args)

    for _ in range(2):  # the first run captures, the second replays
        got = graphed._mpc_stage(params, state)
        assert _equal(got, run_eager("mpc", state))
    state = got[0]
    for i in range(3):
        alpha = graphed._alpha(i, F64)
        got = graphed._tick(params, state, alpha)
        assert _equal(got, run_eager("tick", state, alpha)), i
        state = got[0]
    assert len(cpu_graphs) == 6
    assert graphed.graph_counts() == {"captured": 6, "replayed": 9, "eager": 6}


def test_returned_state_and_log_are_never_overwritten(g1_cpu, cpu_graphs):
    """The state and TickLog a replay hands back stay as they were through
    the next two ticks, and the tick's unchanged fields are the caller's own
    tensors."""
    loop = eng.ControlLoop(g1_cpu, _serving())
    params, state = _walking_start(g1_cpu, loop.cfg, 1, F64)
    state, _ = loop._mpc_stage(params, state)
    state, _ = loop._tick(params, state, loop._alpha(0, F64))  # captures
    held = loop._tick(params, state, loop._alpha(1, F64))      # replays
    assert held[0].U_warm is state.U_warm and held[1].plan_u0 is state.u0
    kept = _copy(held)
    later = held[0]
    for i in (2, 3):
        later, _ = loop._tick(params, later, loop._alpha(i, F64))
    assert _equal(held, kept)
    assert not torch.equal(later.q, held[0].q)


def test_new_storage_recaptures_and_views_replay(g1_cpu, cpu_graphs):
    """Views of the same parameter storage (run_sweep's rows) replay; new
    storage captures again and its values reach the stage."""
    loop = eng.ControlLoop(g1_cpu, _short_wbid())
    base, state = _walking_start(g1_cpu, loop.cfg, 2, F64)
    params = randomize(SweepSpec(n_scenarios=2), torch.Generator().manual_seed(3), base)
    loop._mpc_stage(params, state)
    loop._mpc_stage(params.rows(slice(0, 2)), state)
    assert loop.graph_counts() == {"captured": 3, "replayed": 3, "eager": 3}

    heavier = tree.map_leaves(torch.clone, params)
    heavier = heavier._replace(srbd=heavier.srbd._replace(mass=heavier.srbd.mass * 1.2))
    got = loop._mpc_stage(heavier, state)
    assert loop.graph_counts() == {"captured": 6, "replayed": 3, "eager": 6}
    again = loop._mpc_stage(heavier, state)
    assert _equal(got, again) and not _equal(got, loop._mpc_stage(params, state))


def test_swapped_kernel_wrapper_runs_eagerly(g1_cpu, cpu_graphs, monkeypatch):
    """While a kernel wrapper that the stage launches is swapped (a caller
    compares the kernels with their plain versions, or records their
    inputs) the stage runs eagerly and the swapped function really runs; a
    swap of a kernel the stage does not launch leaves it on its graphs."""
    loop = eng.ControlLoop(g1_cpu, _serving())
    params, state = _walking_start(g1_cpu, loop.cfg, 1, F64)
    loop._mpc_stage(params, state)
    # On the CPU no kernel launches: give the chain the serving MPC's.
    (chain,) = loop._chains.values()
    chain.launches = {"gj_inverse": {"tile": 3}, "gj_solve": {"tile": 3},
                      "admm_iterate": {"tile13": 4}}
    calls = []

    def recording(K, out=None):
        calls.append(K.shape)
        return cuda_lin.PLAIN["chol_inverse_base"](K, out)

    monkeypatch.setattr(cuda_lin, "chol_inverse_base", recording)
    loop._mpc_stage(params, state)
    assert loop.graph_counts() == {"captured": 3, "replayed": 3, "eager": 3}

    def recording_inverse(K):
        calls.append(K.shape)
        return cuda_lin.PLAIN["gj_inverse"](K)

    monkeypatch.setattr(cuda_lin, "gj_inverse", recording_inverse)
    loop._mpc_stage(params, state)
    assert calls and loop.graph_counts() == {"captured": 3, "replayed": 3, "eager": 6}


def test_failed_capture_leaves_the_key_eager(g1_cpu, cpu_graphs, monkeypatch):
    """A segment whose capture raises leaves its key eager for good: no
    partial graph is kept and the capture counts no launches."""
    loop = eng.ControlLoop(g1_cpu, _short_wbid())
    params, state = _walking_start(g1_cpu, loop.cfg, 1, F64)
    capture = eng._capture_graph

    def failing(fn, pool, stream):
        if len(cpu_graphs) == 1:  # the solve segment
            raise RuntimeError("operation not permitted when stream is capturing")
        return capture(fn, pool, stream)

    monkeypatch.setattr(eng, "_capture_graph", failing)
    before = cuda_lin.route_counts()
    eager, _ = loop._mpc_stage(params, state)
    again, _ = loop._mpc_stage(params, state)
    assert _equal(eager, again)
    assert loop.graph_counts() == {"captured": 0, "replayed": 0, "eager": 6}
    assert cuda_lin.route_counts() == before


def test_launch_counts_move_by_route():
    """A capture's launches are taken back and added at each replay,
    exactly, by kernel and route; a route that reaches 0 is dropped."""
    saved = cuda_lin.route_counts()
    try:
        cuda_lin.reset_launch_counts()
        delta = {"gj_inverse": {"tile": 3}, "admm_iterate": {"tile13": 2}}
        eng._add_launches(delta)
        eng._add_launches(delta)
        assert cuda_lin.launch_counts()["gj_inverse"] == 6
        assert eng._route_delta(cuda_lin.route_counts(), {}) == {
            "gj_inverse": {"tile": 6}, "admm_iterate": {"tile13": 4}}
        eng._add_launches(delta, -1)
        eng._add_launches(delta, -1)
        assert cuda_lin.route_counts() == {fn.__name__: {} for fn in cuda_lin.KERNELS}
    finally:
        cuda_lin.reset_launch_counts()
        for fn in cuda_lin.KERNELS:
            fn.routes = dict(saved[fn.__name__])
            fn.launches = sum(fn.routes.values())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_loop(device, config):
    make, _ = CONFIGS[config]
    batch = {"serving": 1, "default": 64}[config]
    model = load_robot("g1_23dof", device=device, dtype=torch.float32)
    loop = eng.ControlLoop(model, make())
    params = eng.default_scenario(device=device, dtype=torch.float32)
    if batch > 1:
        params = randomize(SweepSpec(n_scenarios=batch),
                           torch.Generator(device).manual_seed(5), params)
    return loop, params, eng.init_state(model, loop.cfg, batch, torch.float32)



def _launches(fn):
    before = cuda_lin.route_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, eng._route_delta(cuda_lin.route_counts(), before)


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["serving", "default"])
def test_graphs_equal_eager_on_the_card(cuda, config):
    """Stage by stage from the same state: the replayed graphs equal the
    eager stages bit for bit and launch the same kernels by route; one
    capture per segment, then only replays."""
    loop, params, state = _card_loop(cuda, config)
    state, _ = loop._mpc_stage(params, state)            # eager, then captured
    state, _ = loop._tick(params, state, loop._alpha(0, torch.float32))
    assert loop.graph_counts() == {"captured": 6, "replayed": 0, "eager": 6}
    for i in range(1, 4):
        alpha = loop._alpha(i, torch.float32)
        want, eager_launches = _launches(
            lambda: _eager_stage(loop, "tick", params, state, eng.const(alpha, state.q)))
        got, graph_launches = _launches(lambda: loop._tick(params, state, alpha))
        assert _equal(got, want), i
        assert graph_launches == eager_launches and graph_launches
        state = got[0]
    want, eager_launches = _launches(lambda: _eager_stage(loop, "mpc", params, state))
    got, graph_launches = _launches(lambda: loop._mpc_stage(params, state))
    assert _equal(got, want) and graph_launches == eager_launches
    assert loop.graph_counts() == {"captured": 6, "replayed": 12, "eager": 6}


@pytest.mark.gpu
def test_returned_tensors_survive_replays_on_the_card(cuda):
    loop, params, state = _card_loop(cuda, "serving")
    state, _ = loop._mpc_stage(params, state)
    state, _ = loop._tick(params, state, loop._alpha(0, torch.float32))
    held = loop._tick(params, state, loop._alpha(1, torch.float32))
    kept = _copy(held)
    later = held[0]
    for i in (2, 3):
        later, _ = loop._tick(params, later, loop._alpha(i, torch.float32))
    torch.cuda.synchronize()
    assert _equal(held, kept)


@pytest.mark.gpu
def test_new_storage_never_replays_stale_on_the_card(cuda):
    loop, params, state = _card_loop(cuda, "default")
    loop._mpc_stage(params, state)
    loop._mpc_stage(params.rows(slice(0, 64)), state)
    assert loop.graph_counts() == {"captured": 3, "replayed": 3, "eager": 3}
    heavier = tree.map_leaves(torch.clone, params)
    heavier = heavier._replace(srbd=heavier.srbd._replace(mass=heavier.srbd.mass * 1.2))
    loop._mpc_stage(heavier, state)
    got = loop._mpc_stage(heavier, state)
    assert loop.graph_counts() == {"captured": 6, "replayed": 6, "eager": 6}
    assert _equal(got, _eager_stage(loop, "mpc", heavier, state))


@pytest.mark.gpu
def test_plain_kernels_really_run_on_the_card(cuda, monkeypatch):
    """With the wrappers swapped for their plain versions (chip_smoke.py's
    plain_kernels) the stages run eagerly and no kernel launches; a swap of
    B1 alone (which the serving stages never launch) leaves them on their
    graphs."""
    loop, params, state = _card_loop(cuda, "serving")
    state, _ = loop._mpc_stage(params, state)
    state, _ = loop._tick(params, state, loop._alpha(0, torch.float32))
    monkeypatch.setattr(cuda_lin, "chol_inverse_base", cuda_lin.PLAIN["chol_inverse_base"])
    state, _ = loop._tick(params, state, loop._alpha(1, torch.float32))
    assert loop.graph_counts() == {"captured": 6, "replayed": 3, "eager": 6}
    for name, plain in cuda_lin.PLAIN.items():
        monkeypatch.setattr(cuda_lin, name, plain)
    before = cuda_lin.launch_counts()
    state, _ = loop._mpc_stage(params, state)
    state, log = loop._tick(params, state, loop._alpha(2, torch.float32))
    assert cuda_lin.launch_counts() == before
    assert loop.graph_counts() == {"captured": 6, "replayed": 3, "eager": 12}
    assert bool(torch.isfinite(log.tau).all())


@pytest.mark.gpu
def test_bridge_replays_after_its_first_period_on_the_card(cuda):
    """BridgeController.step at the serving configuration: both stages
    captured in the first period, then every segment replays; its stats
    carry the counts."""
    model = load_robot("g1_23dof", device=cuda, dtype=torch.float32)
    ctrl = BridgeController(model, _serving())
    qpos = eng.q_init_standing(model, 1, torch.float64)[0].cpu().numpy()
    qvel = np.zeros(model.nv)
    ctrl.reset(qpos, qvel)
    for _ in range(41):
        ctrl.step(qpos, qvel)
    assert ctrl.loop.graph_counts() == {"captured": 6, "replayed": 3 * 41, "eager": 6}
    assert ctrl.stats.scalars["graph_replayed"] == 3 * 41


@pytest.mark.gpu
def test_telemetry_times_the_replayed_solves_on_the_card(cuda):
    """EngineConfig.telemetry: the CUDA events go between the replays, and
    a period run from its graphs times its MPC and WBID solves as the
    eager period does (positive, finite, the MPC's the same on every tick)."""
    model = load_robot("g1_23dof", device=cuda, dtype=torch.float32)
    loop = eng.ControlLoop(model, _serving()._replace(telemetry=True))
    params = eng.default_scenario(device=cuda, dtype=torch.float32)
    state = eng.init_state(model, loop.cfg, 1, torch.float32)
    state, _ = loop.period(state, params)
    before = loop.graph_counts()
    _, log = loop.period(state, params)
    after = loop.graph_counts()
    assert after["captured"] == before["captured"] and after["eager"] == before["eager"]
    assert after["replayed"] - before["replayed"] == 3 * (1 + loop.cfg.ticks_per_mpc)
    mpc, wbid = log.mpc_ms.double().cpu(), log.wbid_ms.double().cpu()
    assert bool(torch.isfinite(mpc).all() and torch.isfinite(wbid).all())
    assert bool((mpc > 0).all() and (wbid > 0).all())
    assert torch.equal(mpc, mpc[:, :1].expand_as(mpc))
