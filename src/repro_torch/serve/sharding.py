"""Sharding rules for serving state (counterpart of
``repro/serve/sharding.py``).

The reference gives each cache leaf a PartitionSpec; here a spec is a
tuple with one entry per dim, as ``models.param_pspecs`` gives them
(``()`` for a scalar), and the axis sizes come from the process groups:

  * leading dims are (layers, batch, ...): batch shards over the dp axes
    when they divide it (else it is replicated);
  * among the remaining dims one shards over ``model``: for a 5-d
    attention cache ``(L, B, S, KV, dh)`` kv-heads, then the sequence,
    then head_dim, the first the model axis divides; otherwise the
    largest dim it divides.

The serving steps keep the cache replicated over the model axis
(``serve/step.py::strip_axis``), so only the batch entry decides which
rows a rank's cache holds.
"""
from __future__ import annotations

from .. import tree as tree_mod


def _leaf_spec(shape, dp_axes, dp_size: int, model_size: int) -> tuple:
    nd = len(shape)
    if nd == 0:
        return ()
    spec = [None] * nd
    batch_dim = 1 if nd >= 2 else 0
    if shape[batch_dim] % dp_size == 0 and dp_size > 1:
        spec[batch_dim] = tuple(dp_axes)
    if model_size > 1:
        best = None
        if nd == 5:
            # kv-heads first (no collective in decode attention), then the
            # sequence (flash-decode), head_dim last.
            for i in (3, 2, 4):
                if shape[i] % model_size == 0:
                    best = i
                    break
        if best is None:
            best_size = 0
            for i in range(batch_dim + 1, nd):
                if shape[i] % model_size == 0 and shape[i] > best_size:
                    best, best_size = i, shape[i]
        if best is not None:
            spec[best] = "model"
    return tuple(spec)


def axis_sizes(groups, dp_axes) -> tuple[int, int]:
    """``(dp_size, model_size)`` of ``groups`` (a mapping of axis names
    to process groups; None is one rank)."""
    groups = groups or {}
    dp_size = 1
    for ax in dp_axes:
        dp_size *= groups[ax].size
    model = groups.get("model")
    return dp_size, (model.size if model is not None else 1)


def cache_pspecs(cache, groups, dp_axes):
    """The spec of every leaf of a cache template (tensors, or anything
    with a ``shape``; a Python number is a scalar)."""
    dp_size, model_size = axis_sizes(groups, dp_axes)
    return tree_mod.tree_map(
        lambda x: _leaf_spec(tuple(getattr(x, "shape", ())), dp_axes,
                             dp_size, model_size), cache)
