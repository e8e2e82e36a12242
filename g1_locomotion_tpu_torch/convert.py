"""Parameters and configs of the JAX package, carried over to this port.

The JAX package's ``SRBDParams`` and ``MPCWeights`` arrive as mappings (or
NamedTuples) of numpy arrays, and its ``MPCConfig`` / ``QPConfig`` as their
``_asdict()`` dicts; this module turns them into this package's types on a
given device and dtype. It never imports JAX: callers convert with
``np.asarray`` first.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from g1_locomotion_tpu_torch.models.srbd import SRBDParams
from g1_locomotion_tpu_torch.mpc.solver import MPCConfig, MPCWeights
from g1_locomotion_tpu_torch.ops.qp import QPConfig


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
