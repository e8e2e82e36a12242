"""Checkpoint / resume for long batched sweeps.

Port of ``g1_locomotion_tpu/utils/checkpoint.py``: a nested tree of tensors
(NamedTuples such as ``EngineState`` and ``SweepStats``, tuples, lists,
dicts) saved as one npz of its leaves beside a JSON manifest (leaf count,
structure, the caller's meta). A restore checks the manifest and every
leaf's shape against a template, and gives each leaf the template leaf's
dtype and device, so it never mis-unflattens silently.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from g1_locomotion_tpu_torch.utils import tree


def save(path: str, state: Any, meta: Optional[Dict] = None) -> None:
    """Save a tree of tensors (engine states, sweep statistics, ...)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    flat = tree.leaves(state)
    arrays = {f"leaf_{i}": torch.as_tensor(x).detach().cpu().numpy()
              for i, x in enumerate(flat)}
    np.savez_compressed(p.with_suffix(".npz"), **arrays)
    manifest = {"n_leaves": len(flat), "treedef": tree.structure(state), "meta": meta or {}}
    p.with_suffix(".json").write_text(json.dumps(manifest))


def restore(path: str, like: Any) -> Tuple[Any, Dict]:
    """Restore a checkpoint into the structure of ``like`` (a template tree
    of tensors with the target shapes, dtypes and devices). Returns
    (state, meta); raises ValueError when the leaf count, the structure or a
    leaf's shape differs from the template's."""
    p = Path(path)
    manifest = json.loads(p.with_suffix(".json").read_text())
    with np.load(p.with_suffix(".npz")) as z:
        flat = [z[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    like_flat = tree.leaves(like)
    if len(like_flat) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint {path!r} has {manifest['n_leaves']} leaves but the "
            f"template has {len(like_flat)}: structure mismatch")
    if manifest["treedef"] != tree.structure(like):
        raise ValueError(
            f"checkpoint {path!r} structure does not match the template:\n"
            f"  saved:    {manifest['treedef']}\n  template: {tree.structure(like)}")
    out = []
    for i, (saved, tmpl) in enumerate(zip(flat, like_flat)):
        if saved.shape != tuple(tmpl.shape):
            raise ValueError(f"checkpoint {path!r} leaf {i}: saved shape {saved.shape} != "
                             f"template shape {tuple(tmpl.shape)}")
        out.append(torch.from_numpy(saved).to(device=tmpl.device, dtype=tmpl.dtype))
    return tree.unflatten(like, out), manifest.get("meta", {})


def exists(path: str) -> bool:
    p = Path(path)
    return p.with_suffix(".npz").exists() and p.with_suffix(".json").exists()
