"""Nested pytrees of dicts and lists, flattened in ``jax.tree_util``'s order.

Parameters, gradients and optimizer state are nested dicts and lists of
tensors with the reference's names.  Dict keys flatten sorted and lists
in index order, as ``jax.tree_util`` does, so leaf indices, fusion
buckets and schedules match the reference's exactly.  Anything else (a
tensor, a tuple tag, None) is a leaf; a path names a dict entry by its
key and a list entry by its index.
"""
from __future__ import annotations

from typing import Any, Callable


def _items(node):
    """``(key, child)`` pairs of an inner node in flattening order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, list):
        return list(enumerate(node))
    return None


def leaves(tree) -> list:
    items = _items(tree)
    if items is None:
        return [tree]
    return [leaf for _, child in items for leaf in leaves(child)]


def leaves_with_path(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    items = _items(tree)
    if items is None:
        return [(prefix, tree)]
    return [item for k, child in items
            for item in leaves_with_path(child, prefix + (k,))]


def structure(tree):
    """A hashable description of ``tree``'s nesting, its leaves left
    out: two trees have equal structures exactly when they flatten in
    the same order into the same paths (the plan cache's treedef)."""
    items = _items(tree)
    if items is None:
        return None
    kind = "dict" if isinstance(tree, dict) else "list"
    return (kind, tuple((k, structure(child)) for k, child in items))


_END = object()


def unflatten(like, flat) -> Any:
    """Rebuild ``like``'s structure from ``flat`` (in leaf order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(child) for child in node]
        return next(it)

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    flats = [leaves(t) for t in rest]
    return unflatten(tree, [fn(x, *(f[i] for f in flats))
                            for i, x in enumerate(leaves(tree))])
