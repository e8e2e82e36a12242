"""Parameters, models and configs of the JAX package, carried over to this port.

The JAX package's ``SRBDParams``, ``MPCWeights``, ``WBIDGains`` and
``WBIDReferences`` arrive as mappings (or NamedTuples) of numpy arrays, its
``RobotModel`` as a mapping of its fields (numpy arrays and the static
tuples), and its ``MPCConfig`` / ``QPConfig`` / ``WBIDConfig`` as their
``_asdict()`` dicts; this module turns them into this package's types on a
given device and dtype. It never imports JAX: callers convert with
``np.asarray`` first.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from g1_locomotion_tpu_torch.models.robot import RobotModel
from g1_locomotion_tpu_torch.models.srbd import SRBDParams
from g1_locomotion_tpu_torch.mpc.solver import MPCConfig, MPCWeights
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
