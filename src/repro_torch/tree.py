"""Nested-dict pytrees, flattened in ``jax.tree_util``'s order.

Parameters, gradients and optimizer state are nested dicts of tensors
with the reference's names.  Dicts are the only containers; their keys
flatten sorted, as ``jax.tree_util`` does, so leaf indices, fusion
buckets and schedules match the reference's exactly.  Anything that is
not a dict (a tensor, a tuple tag, None) is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def leaves_with_path(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaves_with_path(tree[k], prefix + (k,))]
    return [(prefix, tree)]


_END = object()


def unflatten(like, flat) -> Any:
    """Rebuild ``like``'s structure from ``flat`` (in leaf order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    flats = [leaves(t) for t in rest]
    return unflatten(tree, [fn(x, *(f[i] for f in flats))
                            for i, x in enumerate(leaves(tree))])
