"""The model axis: parameters held in shards, gathered at the loss.

Counterpart of ``repro/core/manual.py``.  On a ``("pod", "data",
"model")`` mesh each rank holds, of every leaf the model-axis rules
shard (``models.param_pspecs``), only its block along the sharded dim;
the other leaves it holds whole.  A differentiable gather boundary
rebuilds the full tensors for the loss, one ``torch.autograd.Function``
per sharded leaf:

* forward: ``all_gather`` of the shard over the model group, the blocks
  placed along the sharded dim in model-rank order;
* backward: this rank's block of the cotangent, with no sum.  The batch
  is split over the dp axes only, so every model rank computes the loss
  from the same rows and the same full parameters: the cotangents are
  already equal across the model axis, and a sum would count them m
  times.

So a sharded leaf's gradient leaves the backward shard-shaped and a
replicated leaf's full-shaped; the aggregator reduces both over the dp
axes only, and gives replicated buckets the schedule's model bracket
(``shard`` -> the dp stages on a 1/m chunk -> ``ag@model``), so no dp
work is repeated across model ranks (``core/schedule.py``).

A leaf whose sharded dim the model axis does not divide falls back to
replicated, as ``models.divisibility_check`` would report it, so any
architecture runs on any model-axis size.

Specs are tuples with one entry per dim (``None`` or ``"model"``);
``()`` is replicated.
"""
from __future__ import annotations

import torch

from .. import tree as tree_mod
from . import dist as dist_mod

MODEL_AXIS = "model"


def _entry_has(entry) -> bool:
    if entry == MODEL_AXIS:
        return True
    return isinstance(entry, tuple) and MODEL_AXIS in entry


def _restrict(spec) -> tuple:
    """Only the model-axis entries of a spec (the rest replicated)."""
    return tuple(MODEL_AXIS if _entry_has(e) else None for e in spec)


def sharded_dim(spec):
    """Index of the dim sharded over the model axis, or None if
    replicated."""
    for i, e in enumerate(tuple(spec)):
        if _entry_has(e):
            return i
    return None


def model_shard_specs(params, m: int):
    """Per-leaf specs restricted to the model axis, for a model axis of
    size ``m``; a leaf whose sharded dim ``m`` does not divide (or any
    leaf when ``m`` is 1) is replicated, ``()``."""
    from ..models import param_pspecs

    m = int(m)

    def leaf_spec(leaf, spec):
        spec = _restrict(spec)
        dim = sharded_dim(spec)
        if dim is None or m <= 1 or leaf.shape[dim] % m != 0:
            return ()
        return spec

    return tree_mod.tree_map(leaf_spec, params, param_pspecs(params))


def shard_param_structs(params, mspecs, m: int):
    """Meta tensors with the model-sharded dims divided by ``m``: the
    shapes the gradients take, for planning without the parameters."""

    def shrink(leaf, spec):
        dim = sharded_dim(spec)
        shape = tuple(leaf.shape)
        if dim is not None and m > 1:
            shape = shape[:dim] + (shape[dim] // m,) + shape[dim + 1:]
        return torch.empty(shape, dtype=leaf.dtype, device="meta")

    return tree_mod.tree_map(shrink, params, mspecs)


def sharded_mask(params, mspecs):
    """A tree of bools: True where the leaf is model-sharded (its squared
    norm is summed over the model group, ``optim/clip.py``)."""
    return tree_mod.tree_map(
        lambda _, spec: sharded_dim(spec) is not None, params, mspecs)


class _GatherLeaf(torch.autograd.Function):
    """All-gather forward, this rank's block of the cotangent backward
    (see the module docstring: no sum)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.index, ctx.shard = dim, group.rank, x.shape[dim]
        stacked = dist_mod.all_gather(x.detach().contiguous(), group)
        full = torch.movedim(stacked, 0, dim)
        shape = x.shape[:dim] + (x.shape[dim] * group.size,) \
            + x.shape[dim + 1:]
        return full.reshape(shape)

    @staticmethod
    def backward(ctx, ct):
        block = ct.narrow(ctx.dim, ctx.index * ctx.shard, ctx.shard)
        return block.contiguous(), None, None


def gather_params(params, mspecs, group):
    """The full parameters from this rank's shards, differentiably;
    replicated leaves pass through untouched.  ``group``: the model
    axis's :class:`~repro_torch.core.dist.Group` (on ``cuda_ipc`` one
    with a channel bound, :func:`gather_group`)."""
    if group.size == 1:
        return params

    def leaf(x, spec):
        dim = sharded_dim(spec)
        return x if dim is None else _GatherLeaf.apply(x, dim, group)

    return tree_mod.tree_map(leaf, params, mspecs)


def shard_params(params, mspecs, group):
    """This rank's block of every full leaf (a new tensor each), the
    replicated leaves as they are."""

    def leaf(x, spec):
        dim = sharded_dim(spec)
        if dim is None or group.size == 1:
            return x
        shard = x.shape[dim] // group.size
        return x.detach().narrow(dim, group.rank * shard, shard).clone()

    return tree_mod.tree_map(leaf, params, mspecs)


def gather_group(group, params, mspecs, device):
    """``group`` ready to gather ``params``'s shards: on ``cuda_ipc`` an
    :class:`~repro_torch.core.dist.IpcChannel` of its own is opened
    (collective over the model group), with slots of the largest shard;
    on the other transports ``group`` itself."""
    if group.transport != "cuda_ipc" or group.size == 1:
        return group
    largest = max((x.numel() * x.element_size()
                   for x, spec in zip(tree_mod.leaves(params),
                                      tree_mod.leaves(mspecs))
                   if sharded_dim(spec) is not None), default=0)
    return dist_mod.IpcChannel(group, largest, device).group
