"""Process groups for a data-parallel mesh.

Counterpart of ``repro/launch/mesh.py``.  The reference lays devices out
as ``make_mesh((pods, data, model), ("pod", "data", "model"))``, pod
major; here the world's ranks take the same places, and each dp axis is
a :class:`~repro_torch.core.dist.Group` over the ranks that share every
other coordinate:

* data groups ``{k·d, …, k·d + d − 1}``, one per pod ``k``;
* pod groups ``{j, j + d, …}``, one per data index ``j``.

So a rank ``r`` sits at ``(pod, data) = (r // d, r % d)``, and its rows
of a global batch are at index ``r`` (``train.step.shard_batch``), as
the reference's batch spec ``P(("pod", "data"))`` places them.
"""
from __future__ import annotations

import torch.distributed as dist

from ..core.dist import Group

DP_AXES = ("pod", "data")


def make_groups(pods: int, data: int, transport: str | None = None) -> dict:
    """``{"pod": Group, "data": Group}`` of this rank on a ``pods × data``
    mesh of the whole world (``pods · data`` ranks).  Collective over the
    world: every rank calls ``dist.new_group`` for every subgroup, data
    groups first, then pod groups, in the same order, and keeps the two
    it belongs to.  ``transport`` as in :class:`~repro_torch.core.dist.
    Group` (default: the world's)."""
    pods, data = int(pods), int(data)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != pods * data:
        raise ValueError(f"a {pods} x {data} mesh needs {pods * data} "
                         f"ranks, the world has {world}")
    if world == 1:
        return {ax: Group(name=ax, transport=transport) for ax in DP_AXES}
    rank = dist.get_rank()
    mine = {}
    layouts = (("data", [list(range(k * data, (k + 1) * data))
                         for k in range(pods)]),
               ("pod", [list(range(j, world, data)) for j in range(data)]))
    for ax, member_lists in layouts:
        for members in member_lists:
            pg = dist.new_group(members)
            if rank in members:
                mine[ax] = pg
    # Group() of a cuda_ipc world checks its ranks share a host, a
    # collective over the group: every rank builds its data group first.
    out = {ax: Group(mine[ax], name=ax, transport=transport)
           for ax in ("data", "pod")}
    return {ax: out[ax] for ax in DP_AXES}


def dp_axes_of(axis_names) -> tuple:
    """The dp axes among a mesh's axis names, outermost first."""
    return tuple(n for n in axis_names if n in DP_AXES)
