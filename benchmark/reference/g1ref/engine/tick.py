"""The closed-loop control period: gait -> MPC -> 40 x (WBID -> plant).

Port of ``g1_locomotion_tpu/engine/tick.py``, batch-first. The reference
jits one pure function ``(EngineState, params) -> (EngineState, TickLog)``
and rolls it out with ``lax.scan`` over MPC periods (dt = 0.04 s) and, inside
each, over 1 kHz control ticks; here :class:`ControlLoop` is an
``nn.Module`` whose :meth:`ControlLoop.period` runs the MPC stage and then
the ticks in a Python loop, every tensor ``(B, ...)``. Every data-dependent
choice is a ``torch.where`` per instance: a period makes no host sync and
takes no Python branch on data.

Which kernels a period launches follows from the configuration: the
serving configuration (``polish_kernel`` on both QPs) runs B2, B3 and B4 in
the MPC solve and in every tick, the default ``EngineConfig()`` ends every
SPD inverse in B1, and :func:`walking_config` (the factorization path)
runs none. The plant, the planner and the gait FSM are plain tensor ops and
``torch.linalg.solve``.

With ``EngineConfig.telemetry`` a period times its MPC solve and each
tick's WBID solve (``TickLog.mpc_ms`` / ``wbid_ms``): on the card by a CUDA
event pair around each, read once the period's work is queued, so the
period adds no host sync before its end; on the CPU by the host clock.

The MuJoCo bridge (``engine/mujoco_bridge.py``) drives the MPC stage and
the tick of :class:`ControlLoop` itself, one tick per MuJoCo step.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.g1ref._device import const, require_cuda
from benchmark.reference.g1ref.core import rotations as rot
from benchmark.reference.g1ref.engine import plant as plant_mod
from benchmark.reference.g1ref.engine.state import q_init_standing
from benchmark.reference.g1ref.gait import footsteps as fs
from benchmark.reference.g1ref.gait import planner
from benchmark.reference.g1ref.gait import schedule as gs
from benchmark.reference.g1ref.gait import swing as sw
from benchmark.reference.g1ref.gait.schedule import clip
from benchmark.reference.g1ref.models import robot as rb
from benchmark.reference.g1ref.models import srbd
from benchmark.reference.g1ref.models.robot import RobotModel
from benchmark.reference.g1ref.mpc import solver as mpc
from benchmark.reference.g1ref.ops.qp import QPConfig
from benchmark.reference.g1ref.wbid import solver as wbid
from benchmark.reference.g1ref.wbid.stack import StackIndices
from benchmark.reference.g1ref.wbid.tasks import WBIDGains, WBIDReferences, default_gains


class EngineConfig(NamedTuple):
    """Static engine configuration: the reference's fields and defaults
    (its module documents each one)."""

    mpc: mpc.MPCConfig = mpc.MPCConfig()
    wbid: wbid.WBIDConfig = wbid.WBIDConfig()
    plant: plant_mod.PlantConfig = plant_mod.PlantConfig()
    ticks_per_mpc: int = 40
    max_swing_height: float = 0.05  # m
    com_height: float = 0.598       # standing CoM target
    telemetry: bool = False         # per-stage timing into TickLog.mpc_ms / wbid_ms
    log_q: bool = False             # TickLog.q carries the configuration
    torso_task: bool = False        # torso-orientation WBID task
    hand_task: bool = False         # hand carry-hold WBID tasks
    mpc_delay: int = 0              # 0: synchronous; 1: one period stale
    delay_comp: str = "full"        # at mpc_delay 1: "full", "state", "clock", "none"
    gait_gate: bool = False         # weight-transfer clock gate and DS slow-down
    settle_knee_guard: bool = False  # fade in the leg postural task after the walk
    plan_extras: bool = False       # the planner's round-5 mechanisms


class ScenarioParams(NamedTuple):
    """Per-scenario parameters. A leaf of :data:`PER_INSTANCE` is shared by
    the batch (its shape there) or one per instance (a leading batch axis):
    ``srbd.mass`` 0-d or (B,), ``srbd.inertia`` (3, 3) or (B, 3, 3),
    ``wbid_gains.mu`` 0-d or (B,), every ``gait`` and ``steps`` field 0-d or
    (B,), ``v_cmd`` (2,) or (B, 2). Every other leaf is shared."""

    srbd: srbd.SRBDParams
    mpc_weights: mpc.MPCWeights
    wbid_gains: WBIDGains
    gait: gs.GaitConfig
    steps: fs.FootstepConfig
    v_cmd: torch.Tensor  # commanded planar velocity

    def batch(self) -> Optional[int]:
        """The batch size of the per-instance leaves (None if all are shared)."""
        for path, ndim in PER_INSTANCE.items():
            leaf = _leaf(self, path)
            if leaf.dim() > ndim:
                return leaf.shape[0]
        return None

    def rows(self, rows: slice) -> "ScenarioParams":
        """The instances ``rows`` of a batch; shared leaves stay shared."""
        out = self
        for path, ndim in PER_INSTANCE.items():
            leaf = _leaf(out, path)
            if leaf.dim() > ndim:
                out = _replace_leaf(out, path, leaf[rows])
        return out


# The leaves of ScenarioParams that may be per instance, by path, with the
# number of dims they have when shared.
PER_INSTANCE = {
    ("srbd", "mass"): 0, ("srbd", "inertia"): 2, ("wbid_gains", "mu"): 0,
    **{("gait", f): 0 for f in gs.GaitConfig._fields},
    **{("steps", f): 0 for f in fs.FootstepConfig._fields},
    ("v_cmd",): 1,
}


def _leaf(tree, path):
    for name in path:
        tree = getattr(tree, name)
    return tree


def _replace_leaf(tree, path, value):
    if len(path) == 1:
        return tree._replace(**{path[0]: value})
    return tree._replace(**{path[0]: _replace_leaf(getattr(tree, path[0]), path[1:], value)})


def walking_config() -> EngineConfig:
    """The validated walking configuration: horizon 20 with footstep
    optimization, both QPs on the factorization path with full polish (the
    golden's configuration; no kernel). Pair with :func:`walking_scenario`."""
    return EngineConfig(
        mpc=mpc.MPCConfig(
            horizon=20,
            footstep_opt=True,
            qp=QPConfig(iters=60, scaling_iters=0, rho=1.0, rho_segments=2,
                        matmul_inverse=False, polish_rounds=3),
        ),
        wbid=wbid.WBIDConfig(
            qp=QPConfig(iters=50, scaling_iters=3, rho=0.1, rho_segments=2,
                        matmul_inverse=False, polish_rounds=3)
        ),
    )


def walking_config_f32() -> EngineConfig:
    """walking_config plus iterative refinement of every polish KKT solve,
    the reference's float32 mitigation."""
    cfg = walking_config()
    return cfg._replace(
        mpc=cfg.mpc._replace(qp=cfg.mpc.qp._replace(polish_refine=2)),
        wbid=cfg.wbid._replace(qp=cfg.wbid.qp._replace(polish_refine=2)),
    )


def default_scenario(*, device=None, dtype=torch.float32) -> ScenarioParams:
    """The package defaults (an 8-step gait from t = 0.5 s, v_cmd = 0), every
    tensor shared by the batch; ``device=None`` takes the card."""
    device = require_cuda() if device is None else device
    return ScenarioParams(
        srbd=srbd.default_params(device=device, dtype=dtype),
        mpc_weights=mpc.default_weights(device=device, dtype=dtype),
        wbid_gains=default_gains(device=device, dtype=dtype),
        gait=gs.default_gait(device=device, dtype=dtype),
        steps=fs.default_footsteps(device=device, dtype=dtype),
        v_cmd=torch.zeros(2, dtype=dtype, device=device),
    )


def _scalar(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def walking_scenario(*, device=None, dtype=torch.float32, n_steps: float = 8.0,
                     v_cmd=(0.1, 0.0)) -> ScenarioParams:
    """Scenario defaults for dynamic walking (pairs with walking_config):
    walking MPC weights and gait timing scheduled by the commanded speed
    (fast: 0.20 s swing / 0.30 s DS; slow: damped lateral DCM placement,
    sagittal 1.2, step-timing adaptation)."""
    p = default_scenario(device=device, dtype=dtype)
    like = p.v_cmd
    gait = p.gait._replace(n_steps=_scalar(like, n_steps))
    steps = p.steps
    vx = abs(float(v_cmd[0]))
    if vx >= 0.15:
        gait = gait._replace(swing_duration=_scalar(like, 0.20),
                             double_support_duration=_scalar(like, 0.30))
    elif vx <= 0.075:
        steps = steps._replace(dcm_scale=_scalar(like, 0.8), dcm_scale_x=_scalar(like, 1.2))
        gait = gait._replace(timing_gain=_scalar(like, 3.0))
    return p._replace(
        mpc_weights=mpc.walking_weights(device=like.device, dtype=dtype),
        gait=gait, steps=steps,
        v_cmd=torch.tensor(v_cmd, dtype=dtype, device=like.device),
    )


def walking_scenario_f32_robust(*, device=None, dtype=torch.float32, n_steps: float = 8.0,
                                v_cmd=(0.1, 0.0)) -> ScenarioParams:
    """walking_scenario plus the reference's float32 robustness bundle:
    landing lock 0.65, DCM placement 1.3, step timing (gain 3, tol 0.03),
    crouch guard 0.12."""
    p = walking_scenario(device=device, dtype=dtype, n_steps=n_steps, v_cmd=v_cmd)
    like = p.v_cmd
    return p._replace(
        steps=p.steps._replace(dcm_scale=_scalar(like, 1.3)),
        gait=p.gait._replace(timing_gain=_scalar(like, 3.0), timing_tol=_scalar(like, 0.03),
                             gate_z_tol=_scalar(like, 0.12), landing_lock=_scalar(like, 0.65)),
    )


def stale_walking_scenario(*, device=None, dtype=torch.float32, n_steps: float = 8.0,
                           v_cmd=(0.1, 0.0)) -> ScenarioParams:
    """The bundle validated under the stale-solution cadence
    (``mpc_delay=1``, ``delay_comp="full"``): the robust bundle with the
    landing lock at 0.5."""
    p = walking_scenario_f32_robust(device=device, dtype=dtype, n_steps=n_steps, v_cmd=v_cmd)
    return p._replace(gait=p.gait._replace(landing_lock=_scalar(p.v_cmd, 0.5)))


def mujoco_walking_scenario(*, device=None, dtype=torch.float32, n_steps: float = 8.0,
                            v_cmd=(0.1, 0.0)) -> ScenarioParams:
    """walking_scenario for real MuJoCo contacts (pair with
    :func:`walking_config`): the wider stance (0.16 m against 0.12) and the
    longer double support (0.35 s against 0.25) that buy the lateral margin
    real feet do not deliver in single support; 6 steps and the settle are
    the regression point."""
    p = walking_scenario(device=device, dtype=dtype, n_steps=n_steps, v_cmd=v_cmd)
    like = p.v_cmd
    return p._replace(
        steps=p.steps._replace(step_width=_scalar(like, 0.16)),
        gait=p.gait._replace(double_support_duration=_scalar(like, 0.35)),
    )


def mujoco_standing_scenario(*, device=None, dtype=torch.float32) -> ScenarioParams:
    """Quiet standing for MuJoCo (the reference's MuJoCo standing tests,
    tests/test_engine_mujoco.py:25-34): default_scenario with no steps and
    stiffer orientation weights, which real unilateral contacts need."""
    p = default_scenario(device=device, dtype=dtype)
    like = p.v_cmd
    Q = torch.tensor((40.0, 40.0, 50.0, 200.0, 200.0, 500.0, 0.5, 0.5, 0.5, 10.0, 10.0, 10.0,
                      0.0), dtype=dtype, device=like.device)
    return p._replace(gait=p.gait._replace(n_steps=_scalar(like, 0.0)),
                      mpc_weights=mpc.MPCWeights(Q=Q, R=torch.full_like(p.mpc_weights.R, 1e-5)))


def mujoco_nominal_config() -> EngineConfig:
    """walking_config with the weight-transfer gate and DS slow-down
    (``gait_gate``); pair with :func:`mujoco_nominal_scenario`."""
    return walking_config()._replace(gait_gate=True)


def mujoco_nominal_scenario(*, device=None, dtype=torch.float32, n_steps: float = 8.0,
                            v_cmd=(0.1, 0.0)) -> ScenarioParams:
    """walking_scenario at the nominal geometry (width 0.12 m, DS 0.25 s)
    for MuJoCo, with the DS slow-down (gate window 0.4, gain 3, rate floor
    0.5, DCM tolerance 0.02) and the swing-limb momentum preview (m_swing
    1 kg)."""
    p = walking_scenario(device=device, dtype=dtype, n_steps=n_steps, v_cmd=v_cmd)
    like = p.v_cmd
    return p._replace(
        srbd=p.srbd._replace(m_swing=_scalar(like, 1.0)),
        gait=p.gait._replace(gate_window=_scalar(like, 0.4), ds_slow_gain=_scalar(like, 3.0),
                             ds_rate_min=_scalar(like, 0.5), gate_xi_tol=_scalar(like, 0.02)),
    )


def _has_waist_tilt(model: RobotModel) -> bool:
    return any(("waist_roll" in n) or ("waist_pitch" in n) for n in model.joint_names)


def _has_hands(model: RobotModel) -> bool:
    return any("hand_thumb" in n for n in model.joint_names)


def variant_walking_scenario(model: RobotModel, *, dtype=torch.float32, n_steps: float = 8.0,
                             v_cmd=(0.1, 0.0)) -> ScenarioParams:
    """walking_scenario for a robot variant, on the model's device: the SRBD
    parameters of this model at its standing pose (the 23-DoF constants
    destabilize other mass distributions), posture stiffening (w_posture
    2.0) when the variant has waist roll / pitch joints, and the stiff hand
    hold (w_hand 10, hand_kd 40) when it has hands. Pair with
    :func:`variant_walking_config`."""
    p = walking_scenario(device=model.device, dtype=dtype, n_steps=n_steps, v_cmd=v_cmd)
    like = p.v_cmd
    p = p._replace(srbd=srbd.params_from_model(model, q_init_standing(model, 1, dtype)))
    if _has_waist_tilt(model):
        p = p._replace(wbid_gains=p.wbid_gains._replace(w_posture=_scalar(like, 2.0)))
    if _has_hands(model):
        p = p._replace(wbid_gains=p.wbid_gains._replace(w_hand=_scalar(like, 10.0),
                                                        hand_kd=_scalar(like, 40.0)))
    return p


def variant_walking_config(model: RobotModel) -> EngineConfig:
    """walking_config plus the torso-orientation task when the variant has
    waist roll / pitch joints (the upper body above the waist is invisible
    to the single-rigid-body MPC) and the hand tasks when it has hands."""
    cfg = walking_config()
    if _has_waist_tilt(model):
        cfg = cfg._replace(torso_task=True)
    if _has_hands(model):
        cfg = cfg._replace(hand_task=True)
    return cfg


class EngineState(NamedTuple):
    """Carried state of the closed loop, batch-first."""

    q: torch.Tensor               # (B, nq) whole-body configuration
    v: torch.Tensor               # (B, nv) generalized velocity
    t: torch.Tensor               # (B,) sim time
    U_warm: torch.Tensor          # (B, N, 12) MPC warm start
    u0: torch.Tensor              # (B, 12) latest MPC forces
    x_opt0: torch.Tensor          # (B, 13) SRBD state at the latest MPC solve
    x_opt1: torch.Tensor          # (B, 13) latest MPC next-state reference
    contact_now: torch.Tensor     # (B, 4) latest MPC contact flags
    landing: torch.Tensor         # (B, 3) planned touchdown point
    swing_start: torch.Tensor     # (B, 2, 3) lift-off positions per foot
    contact_hold: torch.Tensor    # (B, 2, 3) stance target positions
    contact_hold_R: torch.Tensor  # (B, 2, 3, 3)
    prev_stance: torch.Tensor     # (B, 2) stance flags of the previous tick
    anchors: torch.Tensor         # (B, 4, 3) contact pins of the plant
    gait_clock: torch.Tensor      # (B,) gait time (paused or sped up by the gates)
    swing_xy_ref: torch.Tensor    # (B, 2, 2) receding swing-foot xy reference
    gate_hold: torch.Tensor       # (B,) 1 while the gate freezes the gait clock
    u0_pend: torch.Tensor         # (B, 12) pending solution (mpc_delay = 1)
    x_opt0_pend: torch.Tensor     # (B, 13)
    x_opt1_pend: torch.Tensor     # (B, 13)
    contact_pend: torch.Tensor    # (B, 4)
    landing_pend: torch.Tensor    # (B, 3)


class TickLog(NamedTuple):
    """Per-tick diagnostics, (B, ...) per tick; a period stacks them to
    (B, ticks, ...) and a rollout to (B, periods, ticks, ...)."""

    com: torch.Tensor
    tau: torch.Tensor
    forces: torch.Tensor
    contact: torch.Tensor
    plan_x1: torch.Tensor       # MPC predicted next state
    plan_u0: torch.Tensor       # MPC planned contact forces
    landing: torch.Tensor       # planned touchdown point
    mpc_pri_res: torch.Tensor
    wbid_pri_res: torch.Tensor
    mpc_ms: torch.Tensor        # the period's MPC solve [ms] (0 unless cfg.telemetry)
    wbid_ms: torch.Tensor       # this tick's WBID solve [ms] (0 unless cfg.telemetry)
    q: torch.Tensor             # (B, nq) with cfg.log_q, else (B, 0)


class _StageClock:
    """Stage timing of one period (``cfg.telemetry``): :func:`_timed`
    brackets each timed stage. On the card each stage gets a CUDA event
    pair, and :meth:`read_ms` waits for the last event only once the
    period's work is queued; on the CPU the work runs as it is called, and
    the host clock times it."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans = []

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def spans_ms(self) -> List[float]:
        """The stages' times [ms]; on the card after waiting for the last event."""
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in self.spans]
        self.spans[-1][1].synchronize()
        return [a.elapsed_time(b) for a, b in self.spans]

    def read_ms(self, like: torch.Tensor) -> torch.Tensor:
        """(stages,) the stages' times [ms] on like's device and dtype."""
        ms = torch.tensor(self.spans_ms(), dtype=like.dtype)
        if not self.cuda:
            return ms
        # From pinned memory the copy is queued without a stream sync.
        return ms.pin_memory().to(like.device, non_blocking=True)


@contextlib.contextmanager
def _timed(clock: Optional[_StageClock]):
    """Time the enclosed stage on ``clock`` (nothing when it is None)."""
    if clock is None:
        yield
        return
    start = clock.mark()
    yield
    clock.spans.append((start, clock.mark()))


def _feet(model: RobotModel, idx: StackIndices, body_X):
    poses = [rb.frame_pose(model, body_X, f) for f in idx.feet]
    return torch.stack([P.p for P in poses], dim=1), torch.stack([P.R for P in poses], dim=1)


def _contacts(model: RobotModel, idx: StackIndices, body_X) -> torch.Tensor:
    return torch.stack([rb.frame_pose(model, body_X, f).p for f in idx.contacts], dim=1)


def init_state(model: RobotModel, cfg: EngineConfig, batch: int = 1,
               dtype: Optional[torch.dtype] = None) -> EngineState:
    """The standing start, on the model's device, (batch, ...)."""
    q = q_init_standing(model, batch, dtype)
    idx = StackIndices.from_model(model)
    feet, feet_R = _feet(model, idx, rb.fk(model, q))
    N = cfg.mpc.horizon
    zeros = q.new_zeros
    return EngineState(
        q=q, v=zeros((batch, model.nv)), t=zeros((batch,)),
        U_warm=zeros((batch, N, 12)), u0=zeros((batch, 12)),
        x_opt0=zeros((batch, 13)), x_opt1=zeros((batch, 13)),
        contact_now=q.new_ones((batch, 4)), landing=feet[:, 0], swing_start=feet,
        contact_hold=feet, contact_hold_R=feet_R, prev_stance=q.new_ones((batch, 2)),
        anchors=plant_mod.anchors_from_state(model, idx, q), gait_clock=zeros((batch,)),
        swing_xy_ref=feet[..., :2], gate_hold=zeros((batch,)),
        u0_pend=zeros((batch, 12)), x_opt0_pend=zeros((batch, 13)),
        x_opt1_pend=zeros((batch, 13)), contact_pend=q.new_ones((batch, 4)),
        landing_pend=feet[:, 0],
    )


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (M @ x[..., None])[..., 0]


def srbd_state_from_wholebody(model: RobotModel, q: torch.Tensor, v: torch.Tensor,
                              body_X) -> torch.Tensor:
    """(B, 13) SRBD state [rpy, CoM, world angular velocity, CoM velocity, g]
    of the whole-body state."""
    theta = rot.quat_to_rpy(q[:, 3:7])
    com = rb.com_position(model, body_X)
    omega_world = _mv(body_X.R[:, 0], v[:, 3:6])
    com_vel = rb.com_velocity(model, q, v, body_X)
    g = torch.full_like(com[:, :1], srbd.GRAVITY)
    return torch.cat([theta, com, omega_world, com_vel, g], dim=-1)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as the reference computes it."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where with a (B,) condition against (B, ...) values."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim())), a, b)


class ControlLoop(wbid.ModelModule):
    """The closed loop as a module: the robot model, its :class:`StackIndices`
    and the standing posture are buffers; :meth:`period` runs one MPC solve
    and ``cfg.ticks_per_mpc`` WBID ticks with the plant, :meth:`rollout`
    repeats it (the reference's ``make_rollout``)."""

    def __init__(self, model: RobotModel, cfg: EngineConfig,
                 idx: Optional[StackIndices] = None):
        super().__init__(model, idx)
        if cfg.mpc_delay not in (0, 1):
            raise ValueError("mpc_delay must be 0 (synchronous) or 1 (stale)")
        self.cfg = cfg
        self._rebuild()
        q_stand = q_init_standing(self.model, 1)
        self.register_buffer("posture_q", q_stand[0, 7:])
        if cfg.hand_task and self.idx.hands:
            Xs = rb.fk(self.model, q_stand)
            base_R, base_p = Xs.R[0, 0], Xs.p[0, 0]
            self.register_buffer("hand_offsets", torch.stack([
                base_R.mT @ (rb.frame_pose(self.model, Xs, f).p[0] - base_p)
                for f in self.idx.hands]))  # (2, 3) base-frame offsets
        else:
            self.hand_offsets = None

    # -- the MPC stage ---------------------------------------------------
    def _mpc_stage(self, params: ScenarioParams, state: EngineState,
                   clock: Optional[_StageClock] = None):
        model, idx, cfg = self.model, self.idx, self.cfg
        body_X = rb.fk(model, state.q)
        x0 = srbd_state_from_wholebody(model, state.q, state.v, body_X)
        cpos = _contacts(model, idx, body_X)  # (B, 4, 3)

        plan_clock = state.gait_clock
        if cfg.mpc_delay == 1:
            # Delay compensation: this solve is applied one period from now,
            # so plan from the one-step SRBD prediction of the state then;
            # the first period applies its own solve and plans from the
            # measurement.
            first = state.t < 0.5 * cfg.plant.dt
            if cfg.delay_comp in ("full", "state"):
                r_now = cpos - x0[:, None, 3:6]
                A_c, B_c = srbd.continuous_matrices(params.srbd, x0[:, 2], r_now)
                Ad1, Bd1 = srbd.discretize(A_c, B_c, cfg.mpc.dt)
                u_applied = state.u0_pend * state.contact_pend.repeat_interleave(3, dim=-1)
                x_pred = _mv(Ad1, x0) + _mv(Bd1, u_applied)
                x0 = _where(first, x0, x_pred)
            if cfg.delay_comp in ("full", "clock"):
                plan_clock = state.gait_clock + torch.where(
                    first, torch.zeros_like(plan_clock), torch.full_like(plan_clock, cfg.mpc.dt))

        # During a weight-transfer hold, plan pure station-keeping.
        v_cmd_eff = params.v_cmd * (1.0 - state.gate_hold)[:, None]
        # Landing lock: past that swing fraction the committed foothold is
        # frozen.
        _, in_swing_m, _, progress_m = gs.phase_info(params.gait, plan_clock)
        lock_flag = (in_swing_m & (progress_m > params.gait.landing_lock)).to(x0.dtype)
        prev_landing = state.landing_pend if cfg.mpc_delay == 1 else state.landing
        plan = planner.plan_horizon(
            params.gait, params.steps, v_cmd_eff, x0, cpos, plan_clock, cfg.mpc.horizon,
            cfg.mpc.dt, cfg.com_height, hold=state.gate_hold, prev_landing=prev_landing,
            lock_flag=lock_flag, swing_start=state.swing_start, z_apex=cfg.max_swing_height,
            plan_extras=cfg.plan_extras,
        )
        with _timed(clock):
            sol = mpc.solve(cfg.mpc, params.mpc_weights, params.srbd, x0, plan.x_ref,
                            plan.contact_hor, plan.c_hor, plan.p_ref, U_warm=state.U_warm,
                            landing_mask=plan.landing_mask, hdot_sw=plan.hdot_geom)
        landing = plan.landing
        if cfg.mpc.footstep_opt:
            # Fold in the jointly optimized landing offset, except while the
            # landing lock holds the committed foothold.
            landing = _where(lock_flag > 0.5, plan.landing,
                             planner.apply_landing_offset(plan, sol.d))
        return state._replace(
            U_warm=sol.U, u0=sol.u0, x_opt0=sol.x_horizon[:, 0], x_opt1=sol.x_horizon[:, 1],
            contact_now=plan.contact_hor[:, 0], landing=landing,
        ), sol

    # -- one 1 kHz tick ----------------------------------------------------
    def _tick(self, params: ScenarioParams, state: EngineState, alpha,
              clock: Optional[_StageClock] = None) -> Tuple[EngineState, TickLog]:
        """Gait FSM -> WBID references -> QP -> plant. ``alpha`` = (1 - a, a),
        a in (0, 1] the tick's phase within the MPC period: the CoM and base
        references interpolate x_opt0 -> x_opt1."""
        model, idx, cfg = self.model, self.idx, self.cfg
        gait, dt = params.gait, cfg.plant.dt
        q, dtype = state.q, state.q.dtype
        B = q.shape[0]
        body_X = rb.fk(model, q)

        # Contact FSM from the MPC's active flags.
        left_active = torch.maximum(state.contact_now[:, 0], state.contact_now[:, 1])
        right_active = torch.maximum(state.contact_now[:, 2], state.contact_now[:, 3])
        contact_active = torch.stack([left_active, right_active], dim=-1)  # (B, 2)
        _, in_swing, swing_is_left, progress = gs.phase_info(gait, state.gait_clock)

        # Lift-off latches the swing start; touchdown re-anchors the stance
        # target where the foot landed, at the ground height carried from
        # the standing anchors.
        feet_now, feet_R_now = _feet(model, idx, body_X)
        liftoff = (contact_active < 0.5) & (state.prev_stance > 0.5)
        touchdown = (contact_active > 0.5) & (state.prev_stance < 0.5)
        swing_start = torch.where(liftoff[..., None], feet_now, state.swing_start)
        feet_td = torch.cat([feet_now[..., :2], state.contact_hold[..., 2:]], dim=-1)
        contact_hold = torch.where(touchdown[..., None], feet_td, state.contact_hold)
        contact_hold_R = torch.where(touchdown[..., None, None], feet_R_now, state.contact_hold_R)
        cpos_now = _contacts(model, idx, body_X)
        touchdown_c = touchdown.repeat_interleave(2, dim=-1)
        cpos_td = torch.cat([cpos_now[..., :2], state.anchors[..., 2:]], dim=-1)
        anchors = torch.where(touchdown_c[..., None], cpos_td, state.anchors)

        # Receding swing xy reference, rate-limited to what the leg tracks.
        ds_phase = dt / gait.swing_duration
        ph_now = sw.xy_phase(progress)
        ph_next = sw.xy_phase(clip(progress + ds_phase, 0.0, 1.0))
        frac = clip((ph_next - ph_now) / torch.clamp(1.0 - ph_now, min=1e-6), 0.0, 1.0)
        swinging = (swing_is_left, ~swing_is_left)  # per side, before the in_swing gate

        def swing_xy(side):
            ref = state.swing_xy_ref[:, side]
            step_vec = frac[:, None] * (state.landing[:, :2] - ref)
            step_norm = _norm(step_vec)
            cap = gait.swing_xy_rate_max * dt
            step_vec = step_vec * torch.clamp(cap / torch.clamp(step_norm, min=1e-9),
                                              max=1.0)[:, None]
            return _where(swinging[side] & in_swing, ref + step_vec, feet_now[:, side, :2])

        swing_xy_ref = torch.stack([swing_xy(0), swing_xy(1)], dim=1)

        def swing_refs(side):
            sp = sw.SwingParams(p_start=swing_start[:, side], p_end=state.landing,
                                z_apex=cfg.max_swing_height)
            pos, vel, acc = sw.evaluate(sp, progress, gait.swing_duration)
            # xy from the receding reference, z the sextic profile; the xy
            # velocity and acceleration feedforward zeroed, as the reference.
            zero2 = pos.new_zeros((B, 2))
            pos = torch.cat([swing_xy_ref[:, side], pos[:, 2:]], dim=-1)
            vel = torch.cat([zero2, vel[:, 2:]], dim=-1)
            acc = torch.cat([zero2, acc[:, 2:]], dim=-1)
            on = swinging[side] & in_swing
            return (_where(on, pos, feet_now[:, side]), _where(on, vel, torch.zeros_like(vel)),
                    _where(on, acc, torch.zeros_like(acc)))

        sw0, sw1 = swing_refs(0), swing_refs(1)

        # Base / CoM references, interpolated within the period along the
        # MPC's own prediction; the plan-consistent angular feedforward.
        one_minus, alpha = alpha
        x1 = one_minus * state.x_opt0 + alpha * state.x_opt1
        base_R_ref = rot.rpy_to_matrix(x1[:, 0:3])
        base_angacc = (state.x_opt1[:, 6:9] - state.x_opt0[:, 6:9]) / cfg.mpc.dt
        gvec = const((0.0, 0.0, srbd.GRAVITY), q)
        com_acc = torch.sum(state.u0.reshape(B, 4, 3), dim=1) / params.srbd.mass[..., None] + gvec
        angmom_L = _mv(params.srbd.inertia, x1[:, 6:9])
        angmom_Ldot = _mv(params.srbd.inertia, base_angacc)

        hand_pos = None
        if self.hand_offsets is not None:
            yawR = rot.yaw_matrix(rot.quat_to_rpy(q[:, 3:7])[:, 2])
            hand_pos = q[:, None, 0:3] + self.hand_offsets @ yawR.mT

        posture_legs_scale = None
        if cfg.settle_knee_guard:
            half_g2 = gait.swing_duration + gait.double_support_duration
            t_end_g2 = gait.start_time + gait.n_steps * half_g2
            posture_legs_scale = clip((state.gait_clock - t_end_g2) / 0.3, 0.0, 1.0) * (
                gait.n_steps > 0.5)

        refs = WBIDReferences(
            com_pos=x1[:, 3:6], com_vel=x1[:, 9:12], com_acc=com_acc, base_R=base_R_ref,
            base_angvel=x1[:, 6:9], base_angacc=base_angacc,
            posture_q=self.posture_q.expand(B, -1), contact_pos=contact_hold,
            contact_R=contact_hold_R, swing_pos=torch.stack([sw0[0], sw1[0]], dim=1),
            swing_vel=torch.stack([sw0[1], sw1[1]], dim=1),
            swing_acc=torch.stack([sw0[2], sw1[2]], dim=1), swing_R=contact_hold_R,
            f_des=state.u0.reshape(B, 4, 3), contact_active=contact_active,
            angmom_L=angmom_L, angmom_Ldot=angmom_Ldot,
            torso_R=base_R_ref if cfg.torso_task else None, hand_pos=hand_pos,
            posture_legs_scale=posture_legs_scale,
        )
        with _timed(clock):
            sol = wbid.solve(model, idx, cfg.wbid, params.wbid_gains, q, state.v, refs,
                             body_X=body_X)

        # Whole-body plant, the active contact points pinned.
        q_new, v_new, _ = plant_mod.constrained_step(
            model, idx, cfg.plant, q, state.v, sol.tau, state.contact_now, anchors,
            body_X=body_X)

        # Gait-clock gates (crouch guard, step timing, optional weight-transfer gate).
        com_now = rb.com_position(model, body_X)
        com_vel_now = rb.com_velocity(model, q, state.v, body_X)
        vy_now = com_vel_now[:, 1]
        half = gait.swing_duration + gait.double_support_duration
        tau_g = state.gait_clock - gait.start_time
        step_f = torch.floor(tau_g / half)
        in_gait = (tau_g >= 0.0) & (step_f < gait.n_steps)
        t_in_step = tau_g - step_f * half
        ds = gait.double_support_duration
        omega0_g = torch.sqrt(const(-srbd.GRAVITY, q) / cfg.com_height)
        W_g = params.steps.step_width
        next_swing_left = torch.remainder(torch.clamp(step_f, min=0.0), 2.0) < 0.5
        y_stance_g = torch.where(next_swing_left, feet_now[:, 1, 1], feet_now[:, 0, 1])
        y_line_g = y_stance_g + torch.where(next_swing_left, W_g, -W_g)
        xi_rel_g = com_now[:, 1] - y_line_g + (vy_now - params.v_cmd[..., 1]) / omega0_g
        in_ds_end = in_gait & (t_in_step < ds) & (t_in_step > 0.8 * ds)
        z_ok = (com_now[:, 2] > cfg.com_height - gait.gate_z_tol) & (
            com_vel_now[:, 2] > -gait.gate_vz_tol)
        in_ss_t = in_gait & (t_in_step >= ds)
        speedup = gs.timing_clock_rate(gait, omega0_g, W_g, xi_rel_g, t_in_step,
                                       next_swing_left)
        # Feasibility cap: never faster than the rate-limited swing foot can
        # still reach the landing.
        ref_sw = _where(next_swing_left, state.swing_xy_ref[:, 0], state.swing_xy_ref[:, 1])
        d_xy = _norm(state.landing[:, :2] - ref_sw)
        t_rem_sw = torch.clamp(half - t_in_step, min=1e-3)
        r_feas = gait.swing_xy_rate_max * t_rem_sw / torch.clamp(d_xy, min=1e-6)
        speedup = torch.minimum(speedup, torch.clamp(r_feas, min=1.0))
        clock_rate = torch.where(in_ss_t, speedup, 1.0)
        if cfg.gait_gate:
            in_ds_tail = in_gait & (t_in_step < ds) & (t_in_step > (1.0 - gait.gate_window) * ds)
            xi_pred_g = gs.predict_ds_end_dcm(gait, omega0_g, W_g, xi_rel_g, t_in_step,
                                              next_swing_left)
            xi_target = gait.sway_gain * gs.swing_onset_dcm_nominal(gait, omega0_g, W_g,
                                                                     next_swing_left)
            gate_err = torch.where(next_swing_left, xi_pred_g - xi_target,
                                   xi_target - xi_pred_g)
            gate_ok = gate_err < gait.gate_xi_tol
            ds_rate = clip(
                1.0 - gait.ds_slow_gain * torch.clamp(gate_err - gait.gate_xi_tol, min=0.0),
                torch.clamp(gait.ds_rate_min, min=1e-2), 1.0)
            ds_tail_rate = torch.where(gait.ds_slow_gain > 0.0, ds_rate,
                                       (~(in_ds_tail & ~gate_ok)).to(dtype))
            clock_rate = torch.where(in_ds_tail, ds_tail_rate, clock_rate)
        clock_rate = torch.where(in_ds_end & ~z_ok, 0.0, clock_rate)
        # gate_hold marks only full freezes.
        gate_hold = (clock_rate < 1e-6).to(dtype)

        zeros = q.new_zeros((B,))
        log = TickLog(
            com=com_now, tau=sol.tau, forces=sol.forces, contact=state.contact_now,
            plan_x1=state.x_opt1, plan_u0=state.u0, landing=state.landing,
            mpc_pri_res=zeros, wbid_pri_res=sol.pri_res, mpc_ms=zeros, wbid_ms=zeros,
            q=q_new if cfg.log_q else q.new_zeros((B, 0)),
        )
        new_state = state._replace(
            q=q_new, v=v_new, t=state.t + dt, swing_start=swing_start,
            contact_hold=contact_hold, contact_hold_R=contact_hold_R,
            prev_stance=contact_active.to(dtype), anchors=anchors,
            gait_clock=state.gait_clock + clock_rate * dt, swing_xy_ref=swing_xy_ref,
            gate_hold=gate_hold,
        )
        return new_state, log

    # -- the period and the rollout ---------------------------------------
    def _alpha(self, i: int, dtype: torch.dtype) -> Tuple[float, float]:
        """(1 - a, a), a the tick's phase within the MPC's prediction
        interval, computed in the state's precision as the reference does."""
        f = np.float64 if dtype == torch.float64 else np.float32
        a = np.minimum((f(i) + f(1.0)) * f(self.cfg.plant.dt) / f(self.cfg.mpc.dt), f(1.0))
        return float(f(1.0) - a), float(a)

    def period(self, state: EngineState, params: ScenarioParams
               ) -> Tuple[EngineState, TickLog]:
        """One MPC solve and ``ticks_per_mpc`` ticks: (the next state, the
        period's log (B, ticks, ...))."""
        cfg = self.cfg
        prev = state
        clock = _StageClock(state.q.device) if cfg.telemetry else None
        state, mpc_sol = self._mpc_stage(params, state, clock)
        if cfg.mpc_delay == 1:
            # Stale cadence: this period runs on the previous period's
            # solution; the first period applies its own.
            first = prev.t < 0.5 * cfg.plant.dt
            state = state._replace(
                u0=_where(first, state.u0, prev.u0_pend),
                x_opt0=_where(first, state.x_opt0, prev.x_opt0_pend),
                x_opt1=_where(first, state.x_opt1, prev.x_opt1_pend),
                contact_now=_where(first, state.contact_now, prev.contact_pend),
                landing=_where(first, state.landing, prev.landing_pend),
                u0_pend=state.u0, x_opt0_pend=state.x_opt0, x_opt1_pend=state.x_opt1,
                contact_pend=state.contact_now, landing_pend=state.landing,
            )
        logs: List[TickLog] = []
        for i in range(cfg.ticks_per_mpc):
            state, log = self._tick(params, state, self._alpha(i, state.q.dtype), clock)
            logs.append(log)
        log = TickLog(*(torch.stack(f, dim=1) for f in zip(*logs)))
        T = cfg.ticks_per_mpc
        log = log._replace(mpc_pri_res=mpc_sol.pri_res[:, None].expand(-1, T))
        if clock is not None:
            # The MPC solve's time on every tick of the period, each tick's
            # own WBID solve's.
            ms = clock.read_ms(state.q)
            log = log._replace(mpc_ms=ms[0].expand(log.mpc_ms.shape),
                               wbid_ms=ms[None, 1:].expand(log.wbid_ms.shape))
        return state, log

    def rollout(self, state: EngineState, params: ScenarioParams, n_periods: int
                ) -> Tuple[EngineState, TickLog]:
        """``n_periods`` periods: (the final state, the log (B, n_periods,
        ticks, ...))."""
        logs = []
        for _ in range(n_periods):
            state, log = self.period(state, params)
            logs.append(log)
        return state, TickLog(*(torch.stack(f, dim=1) for f in zip(*logs)))
