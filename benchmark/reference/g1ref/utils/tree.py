"""Nested containers of tensors: NamedTuples, tuples, lists and dicts.

The port's counterpart of the ``jax.tree_util`` calls the reference makes on
its pytrees. A leaf is anything that is not one of those containers and not
None (None is an empty subtree, as in JAX). Dicts are walked in sorted key
order, as JAX walks them.
"""

from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any):
    """(children, rebuild) of a container, or None for a leaf."""
    if _is_namedtuple(tree):
        return list(tree), lambda xs: type(tree)(*xs)
    if isinstance(tree, (tuple, list)):
        return list(tree), lambda xs: type(tree)(xs)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda xs: dict(zip(keys, xs))
    return None


def structure(tree: Any) -> str:
    """The tree's shape as a string, leaves as ``*``: equal strings, equal
    structures."""
    if tree is None:
        return "None"
    if _is_namedtuple(tree):
        return f"{type(tree).__name__}(" + ", ".join(
            f"{k}={structure(v)}" for k, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(structure(v) for v in tree)
        return f"({inner},)" if isinstance(tree, tuple) else f"[{inner}]"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}" for k in sorted(tree)) + "}"
    return "*"


def leaves(tree: Any) -> List[Any]:
    """The leaves in order (depth first)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for child in kids[0] for leaf in leaves(child)]


def unflatten(like: Any, values: List[Any]) -> Any:
    """A tree of like's structure holding ``values`` as its leaves, in order."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        kids = _children(t)
        if kids is None:
            return next(it)
        return kids[1]([build(c) for c in kids[0]])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than the template has leaves")
    return out


def map_leaves(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """fn over the leaves of ``tree`` (and the matching leaves of ``rest``,
    trees of the same structure)."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])

