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

Sequence parallelism (``seq=True``; the reference's ``seq_parallel``,
there a GSPMD constraint on the residual stream): each model rank runs
the loss on its chunk of the sequence (``models/transformer.py``), so
the cotangents differ across the model ranks and the boundary sums
them: a sharded leaf gathers forward and reduce-scatters backward (its
block of the sum over the model ranks), a replicated leaf passes
through forward and is summed over the model group backward.  After it
the replicated gradients are equal on every model rank, so the
aggregator's bracketed plan stays as it is.  :func:`seq_gather` is the
activations' boundary: an all-gather along the sequence forward, a
reduce-scatter backward.  The reduce-scatter is a ring of ``m - 1``
ppermute hops (``dist.ppermute``, so it runs on every transport,
through the group's channel on ``cuda_ipc``).

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


def _all_gather_dim(x, dim: int, group) -> torch.Tensor:
    """Every model rank's ``x`` joined along ``dim`` in rank order."""
    stacked = dist_mod.all_gather(x.detach().contiguous(), group)
    full = torch.movedim(stacked, 0, dim)
    return full.reshape(x.shape[:dim] + (x.shape[dim] * group.size,)
                        + x.shape[dim + 1:])


class _GatherLeaf(torch.autograd.Function):
    """All-gather forward, this rank's block of the cotangent backward
    (see the module docstring: no sum)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.index, ctx.shard = dim, group.rank, x.shape[dim]
        return _all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, ct):
        block = ct.narrow(ctx.dim, ctx.index * ctx.shard, ctx.shard)
        return block.contiguous(), None, None


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every model rank's
    ``x``: a ring of ``m - 1`` hops, each sending one block, the partial
    sum of block ``r - t - 1`` going to rank ``r + 1`` at step ``t``."""
    m, r = group.size, group.rank
    if x.shape[dim] % m:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {m} ranks")
    blocks = [b.contiguous() for b in x.chunk(m, dim)]
    ring = [(i, (i + 1) % m) for i in range(m)]
    acc = blocks[(r - 1) % m]
    for t in range(m - 1):
        got = dist_mod.ppermute(acc, group, ring)
        acc = got + blocks[(r - t - 2) % m]
    return acc


class _GatherLeafSeq(torch.autograd.Function):
    """All-gather forward, this rank's block of the summed cotangent
    backward (sequence parallelism: the model ranks' cotangents
    differ)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, ct):
        return reduce_scatter(ct, ctx.dim, ctx.group), None, None


class _SumBackward(torch.autograd.Function):
    """Identity forward, the cotangent summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return dist_mod.psum(ct.contiguous(), ctx.group), None


def seq_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x``'s chunks of every model rank joined along ``dim``,
    differentiably: all-gather forward, reduce-scatter backward (the
    model ranks' cotangents of the whole sequence summed, each keeping
    its chunk's)."""
    if group.size == 1:
        return x
    return _GatherLeafSeq.apply(x, dim, group)


def gather_params(params, mspecs, group, seq: bool = False):
    """The full parameters from this rank's shards, differentiably;
    replicated leaves pass through untouched (with ``seq``, summed over
    the model group backward).  ``group``: the model axis's
    :class:`~repro_torch.core.dist.Group` (on ``cuda_ipc`` one with a
    channel bound, :func:`gather_group`)."""
    if group.size == 1:
        return params

    def leaf(x, spec):
        dim = sharded_dim(spec)
        if seq:
            return _SumBackward.apply(x, group) if dim is None \
                else _GatherLeafSeq.apply(x, dim, group)
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


def own_group(group):
    """A second process group over ``group``'s ranks, with its
    transport: collectives that the backward issues on the main thread
    then never share a process group with the overlap channel's thread.
    Collective over the group's ranks only (local synchronization)."""
    if group.size == 1 or not torch.distributed.is_initialized():
        return group
    ranks = [group.global_rank(r) for r in range(group.size)]
    pg = torch.distributed.new_group(ranks, use_local_synchronization=True)
    return dist_mod.Group(pg, name=group.name, transport=group.transport)
