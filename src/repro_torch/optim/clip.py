"""Global-norm gradient clipping (counterpart of ``repro/optim/clip.py``).
The step clips AFTER aggregation, so the norm is the global-batch
gradient norm, identical on every rank.

On the model axis (``core/manual.py``) a model-sharded leaf's gradient
is one block per model rank and a replicated leaf's is the same whole
gradient on every model rank.  ``sharded``/``model_group`` make the
norm exact there: the squared sums of sharded leaves are summed over
the model group, replicated leaves are counted once.  With neither the
norm is the plain one, bit for bit.
"""
from __future__ import annotations

import torch

from .. import tree as tree_mod
from ..core import dist as dist_mod


def _sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.to(torch.float32)))


def global_norm(tree, sharded=None, model_group=None) -> torch.Tensor:
    """L2 norm of all leaves, summed leaf by leaf in tree order.
    ``sharded``: a tree of bools matching ``tree``, True for leaves that
    hold one model shard, whose squared sums are summed over
    ``model_group`` (a :class:`~repro_torch.core.dist.Group`)."""
    leaves = tree_mod.leaves(tree)
    if sharded is None or model_group is None:
        return torch.sqrt(sum(_sq(x) for x in leaves))
    flags = tree_mod.leaves(sharded)
    if len(leaves) != len(flags):
        raise ValueError(f"sharded mask has {len(flags)} leaves for a "
                         f"{len(leaves)}-leaf tree")
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    sq_sharded = sum((_sq(x) for x, f in zip(leaves, flags) if f), zero)
    sq_repl = sum((_sq(x) for x, f in zip(leaves, flags) if not f), zero)
    return torch.sqrt(dist_mod.psum(sq_sharded, model_group) + sq_repl)


def clip_by_global_norm(tree, max_norm: float, sharded=None,
                        model_group=None):
    norm = global_norm(tree, sharded=sharded, model_group=model_group)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_mod.tree_map(lambda x: x * scale.to(x.dtype), tree), norm
