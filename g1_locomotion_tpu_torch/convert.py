"""Parameters, models and configs of the JAX package, carried over to this port.

The JAX package's ``SRBDParams``, ``MPCWeights``, ``WBIDGains``,
``WBIDReferences``, ``GaitConfig``, ``FootstepConfig``, ``ScenarioParams``
and ``EngineState`` arrive as mappings (or NamedTuples) of numpy arrays,
its ``RobotModel`` as a mapping of its fields (numpy arrays and the static
tuples), and its ``MPCConfig`` / ``QPConfig`` / ``WBIDConfig`` /
``PlantConfig`` / ``EngineConfig`` as their ``_asdict()`` dicts (or the
NamedTuples), its ``SRBDLoopState`` as its fields; this module turns them
into this package's types on a given device and dtype, batch-first. It never imports JAX: callers convert with
``np.asarray`` first (a JAX array converts where numpy reads it).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from g1_locomotion_tpu_torch.engine.plant import PlantConfig
from g1_locomotion_tpu_torch.engine.tick import (PER_INSTANCE, EngineConfig, EngineState,
                                                  ScenarioParams)
from g1_locomotion_tpu_torch.gait.footsteps import FootstepConfig
from g1_locomotion_tpu_torch.gait.schedule import GaitConfig
from g1_locomotion_tpu_torch.models.robot import RobotModel
from g1_locomotion_tpu_torch.models.srbd import SRBDParams
from g1_locomotion_tpu_torch.mpc.solver import MPCConfig, MPCWeights
from g1_locomotion_tpu_torch.mpc.srbd_loop import SRBDLoopState
from g1_locomotion_tpu_torch.ops.qp import QPConfig
from g1_locomotion_tpu_torch.wbid.solver import WBIDConfig
from g1_locomotion_tpu_torch.wbid.tasks import WBIDGains, WBIDReferences

# RobotModel's static fields, as the reference's model has them.
_ROBOT_STATIC = ("parent", "body_names", "joint_names", "frame_names", "frame_body",
                 "ancestor_mask")


def _fields(obj: Any) -> Mapping[str, Any]:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def _tensor(value: Any, *, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(value), dtype=dtype, device=device)


def srbd_params(params: Any, *, device, dtype=torch.float32) -> SRBDParams:
    """SRBDParams from the reference's fields (mass, inertia[, m_swing])."""
    return SRBDParams(**{k: _tensor(v, device=device, dtype=dtype)
                         for k, v in _fields(params).items()})


def mpc_weights(weights: Any, *, device, dtype=torch.float32) -> MPCWeights:
    """MPCWeights from the reference's fields (Q, R)."""
    return MPCWeights(**{k: _tensor(v, device=device, dtype=dtype)
                         for k, v in _fields(weights).items()})


def qp_config(cfg: Any) -> QPConfig:
    """QPConfig from the reference's QPConfig fields; an unknown field raises."""
    return QPConfig(**_fields(cfg))


def mpc_config(cfg: Any) -> MPCConfig:
    """MPCConfig from the reference's MPCConfig fields, its ``qp`` field a
    dict or NamedTuple of QPConfig fields; an unknown field raises."""
    fields = dict(_fields(cfg))
    if "qp" in fields:
        fields["qp"] = qp_config(fields["qp"])
    return MPCConfig(**fields)


def robot_model(fields: Any, *, device, dtype=torch.float32) -> RobotModel:
    """RobotModel from the reference model's fields: its arrays (numpy) and
    its static tuples (``dataclasses.asdict``-like mapping or the model)."""
    if not isinstance(fields, Mapping):
        fields = {k: getattr(fields, k) for k in
                  ("joint_origin_p", "joint_origin_R", "joint_axis", "mass", "com", "inertia",
                   "q_lower", "q_upper", "dq_max", "tau_max", "frame_p", "frame_R")
                  + _ROBOT_STATIC}
    static = {k: tuple(tuple(r) if isinstance(r, (tuple, list)) else r for r in fields[k])
              for k in _ROBOT_STATIC}
    arrays = {k: _tensor(v, device=device, dtype=dtype)
              for k, v in fields.items() if k not in _ROBOT_STATIC}
    return RobotModel(
        **arrays, **static,
        ancestor=_tensor(np.asarray(static["ancestor_mask"], dtype=np.float64).reshape(
            len(static["parent"]), len(static["parent"]) - 1), device=device, dtype=dtype),
        parent_index=torch.tensor(static["parent"][1:], dtype=torch.long, device=device),
    )


def wbid_gains(gains: Any, *, device, dtype=torch.float32) -> WBIDGains:
    """WBIDGains from the reference's fields."""
    return WBIDGains(**{k: _tensor(v, device=device, dtype=dtype)
                        for k, v in _fields(gains).items()})


def wbid_references(refs: Any, *, device, dtype=torch.float32) -> WBIDReferences:
    """WBIDReferences from the reference's fields, each with a leading batch
    axis; the optional fields may be None."""
    return WBIDReferences(**{k: None if v is None else _tensor(v, device=device, dtype=dtype)
                             for k, v in _fields(refs).items()})


def wbid_config(cfg: Any) -> WBIDConfig:
    """WBIDConfig from the reference's WBIDConfig fields, its ``qp`` field a
    dict or NamedTuple of QPConfig fields; an unknown field raises."""
    fields = dict(_fields(cfg))
    if "qp" in fields:
        fields["qp"] = qp_config(fields["qp"])
    return WBIDConfig(**fields)


def gait_config(gait: Any, *, device, dtype=torch.float32) -> GaitConfig:
    """GaitConfig from the reference's fields, each 0-d (shared) or (B,)."""
    return GaitConfig(**{k: _tensor(v, device=device, dtype=dtype)
                         for k, v in _fields(gait).items()})


def footstep_config(steps: Any, *, device, dtype=torch.float32) -> FootstepConfig:
    """FootstepConfig from the reference's fields, each 0-d (shared) or (B,)."""
    return FootstepConfig(**{k: _tensor(v, device=device, dtype=dtype)
                             for k, v in _fields(steps).items()})


def scenario_params(params: Any, *, device, dtype=torch.float32) -> ScenarioParams:
    """ScenarioParams from the reference's (srbd, mpc_weights, wbid_gains,
    gait, steps, v_cmd), each leaf shared or, where ``engine.tick.
    PER_INSTANCE`` allows it, per instance (a leading batch axis)."""
    f = _fields(params)
    like = dict(device=device, dtype=dtype)
    return ScenarioParams(
        srbd=srbd_params(f["srbd"], **like), mpc_weights=mpc_weights(f["mpc_weights"], **like),
        wbid_gains=wbid_gains(f["wbid_gains"], **like), gait=gait_config(f["gait"], **like),
        steps=footstep_config(f["steps"], **like), v_cmd=_tensor(f["v_cmd"], **like),
    )


def scenario_batch(params: Any, *, device, dtype=torch.float32) -> ScenarioParams:
    """ScenarioParams from a batch of the reference's, every leaf with a
    leading batch axis (its ``parallel/sweep.randomize`` tiles each one): a
    leaf whose rows are all equal is kept shared, one whose rows differ per
    instance. Only the leaves of ``engine.tick.PER_INSTANCE`` may differ."""
    def leaf(path, x):
        x = np.asarray(x)
        if np.array_equal(np.broadcast_to(x[:1], x.shape), x, equal_nan=True):
            return x[0]
        if path not in PER_INSTANCE:
            raise ValueError(f"scenario_batch: {'.'.join(path)} differs between instances; "
                             "the port takes it shared only")
        return x

    f = _fields(params)
    groups = {k: {n: leaf((k, n), x) for n, x in _fields(v).items()}
              for k, v in f.items() if k != "v_cmd"}
    return scenario_params({**groups, "v_cmd": leaf(("v_cmd",), f["v_cmd"])},
                           device=device, dtype=dtype)


def plant_config(cfg: Any) -> PlantConfig:
    """PlantConfig from the reference's fields; an unknown field raises."""
    return PlantConfig(**_fields(cfg))


def engine_config(cfg: Any) -> EngineConfig:
    """EngineConfig from the reference's fields, its ``mpc``, ``wbid`` and
    ``plant`` fields dicts or NamedTuples; an unknown field raises."""
    fields = dict(_fields(cfg))
    for name, conv in (("mpc", mpc_config), ("wbid", wbid_config), ("plant", plant_config)):
        if name in fields:
            fields[name] = conv(fields[name])
    return EngineConfig(**fields)


def _batched(fields: Mapping[str, Any], single: bool, *, device, dtype) -> dict:
    """The fields as tensors, each with a batch axis of 1 added when `single`."""
    return {k: _tensor(np.asarray(v)[None] if single else v, device=device, dtype=dtype)
            for k, v in fields.items()}


def engine_state(state: Any, *, device, dtype=torch.float32) -> EngineState:
    """EngineState from the reference's fields: one instance (``q`` of shape
    (nq,)) gains a batch axis of 1, a batched state (``q`` (B, nq)) keeps
    its own."""
    f = _fields(state)
    return EngineState(**_batched(f, np.ndim(f["q"]) == 1, device=device, dtype=dtype))


def srbd_loop_state(state: Any, *, device, dtype=torch.float32) -> SRBDLoopState:
    """SRBDLoopState from the reference's fields: one instance (``x`` of
    shape (13,)) gains a batch axis of 1, a batched state keeps its own."""
    f = _fields(state)
    return SRBDLoopState(**_batched(f, np.ndim(f["x"]) == 1, device=device, dtype=dtype))
