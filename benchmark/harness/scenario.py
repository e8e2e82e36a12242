"""Build one side's inputs from a configuration and the traffic's draws.

The same functions serve the program and the plain reference: each side
passes its own ``EngineConfig`` / ``ScenarioParams`` (NamedTuples with the
same fields), so both get the same configuration and the same drawn
values, and neither takes anything the other made.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def apply_overrides(cfg, overrides: Dict[str, object]):
    """``cfg`` (nested NamedTuples) with each dotted path set to its value."""
    for path, value in overrides.items():
        cfg = _replace(cfg, path.split("."), value)
    return cfg


def _replace(tree, names, value):
    if len(names) == 1:
        if names[0] not in tree._fields:
            raise KeyError(f"benchmark: {type(tree).__name__} has no field {names[0]!r}")
        return tree._replace(**{names[0]: value})
    return tree._replace(**{names[0]: _replace(getattr(tree, names[0]), names[1:], value)})


def get_path(tree, path: str):
    for name in path.split("."):
        tree = getattr(tree, name)
    return tree


class Draws(NamedTuple):
    """The traffic's per-instance values, (B,) each, by draw name, in the
    configuration's dtype on the generator's device."""

    values: Dict[str, torch.Tensor]


def generator(seed: int, device) -> torch.Generator:
    """The run's generator; any seed up to 2**63 - 1."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63 - 1))
    return gen


def uniform(gen: torch.Generator, lohi, n: int, dtype) -> torch.Tensor:
    """n draws from U[lo, hi], made in float64 and rounded once to dtype."""
    lo, hi = float(lohi[0]), float(lohi[1])
    u = torch.rand((n,), generator=gen, dtype=torch.float64, device=gen.device)
    return (lo + (hi - lo) * u).to(dtype)


def draw_instances(traffic: dict, gen: torch.Generator, batch: int, dtype) -> Draws:
    """Every entry of ``traffic['draws']``, in order, ``batch`` values each."""
    return Draws({d["name"]: uniform(gen, d["range"], batch, dtype)
                  for d in traffic.get("draws", [])})


def apply_draws(params, traffic: dict, draws: Draws):
    """``params`` (a side's ScenarioParams, shared leaves) with the drawn
    values: ``leaf`` (optionally one ``column``) set per instance, or every
    leaf of ``scale`` multiplied per instance."""
    for d in traffic.get("draws", []):
        x = draws.values[d["name"]]
        like = params.v_cmd
        x = x.to(device=like.device, dtype=like.dtype)
        if "scale" in d:
            for path in d["scale"]:
                leaf = get_path(params, path)
                params = apply_overrides(params, {path: leaf * x.reshape((-1,) + (1,) * leaf.dim())})
            continue
        leaf = get_path(params, d["leaf"])
        if "column" in d:
            if leaf.dim() == 1:
                leaf = leaf.expand(x.shape[0], -1)
            leaf = leaf.clone()
            leaf[:, d["column"]] = x
            params = apply_overrides(params, {d["leaf"]: leaf})
        else:
            params = apply_overrides(params, {d["leaf"]: x})
    return params


def episode_draw(traffic: dict, key: str, gen: torch.Generator, batch: int,
                 dtype) -> Optional[torch.Tensor]:
    """(batch,) values of the per-episode draw ``traffic[key]['range']``, or
    None where the mix has no such draw."""
    spec = traffic.get(key)
    if spec is None:
        return None
    return uniform(gen, spec["range"], batch, dtype)
