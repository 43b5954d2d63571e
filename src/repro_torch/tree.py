"""Nested parameter and state trees (no JAX counterpart needed beyond what
``jax.tree_util`` gives the reference).

A tree is a dict (walked in sorted-key order, as ``jax.tree_util`` walks
it), an ``api.DipWeight`` (children: its ``data``, then its ABFT
``checksum`` when it has one), a named tuple (its fields in order, a
``None`` field an empty subtree: ``reliability.AbftChecksum``) or a leaf: a
tensor or a Python number.  :func:`paths` names the leaves as the
reference's checkpoints do (``jax.tree_util.keystr`` parts joined by ``/``,
e.g. ``['params']/['layers']/['wq']/.data`` and
``['params']/['layers']/['wq']/.checksum/.row``).  A ``DipWeight``'s
metadata, its ``WeightPlan`` included, rides through :func:`unflatten` (the
reference's static aux data).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

from repro_torch.api.weights import DipWeight

__all__ = ["leaves", "paths", "unflatten", "map_tree"]


def paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in flattening order."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out += paths(tree[k], f"{prefix}/[{k!r}]" if prefix else f"[{k!r}]")
        return out
    if isinstance(tree, DipWeight):
        return paths(tree.data, f"{prefix}/.data") + paths(tree.checksum, f"{prefix}/.checksum")
    if _is_namedtuple(tree):
        return [pl for f, v in zip(tree._fields, tree) for pl in paths(v, f"{prefix}/.{f}")]
    if tree is None:
        return []
    return [(prefix, tree)]


def _is_namedtuple(t: Any) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in paths(tree)]


def unflatten(like: Any, flat) -> Any:
    """A tree with the structure of ``like`` and the leaves ``flat`` (in
    flattening order)."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, DipWeight):
            return t.with_data(build(t.data), checksum=build(t.checksum))
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if t is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    flat = [fn(*xs) for xs in zip(leaves(tree), *(leaves(r) for r in rest))]
    return unflatten(tree, flat)
