"""Global-norm gradient clipping (counterpart of ``repro/optim/clip.py``,
data-parallel case).  The step clips AFTER aggregation, so the norm is
the global-batch gradient norm, identical on every rank."""
from __future__ import annotations

import torch

from .. import tree as tree_mod


def global_norm(tree) -> torch.Tensor:
    """L2 norm of all leaves, summed leaf by leaf in tree order."""
    leaves = tree_mod.leaves(tree)
    total = sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves)
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_mod.tree_map(lambda x: x * scale.to(x.dtype), tree), norm
