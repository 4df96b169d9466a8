"""Process groups for a pod × data × model mesh.

Counterpart of ``repro/launch/mesh.py``.  The reference lays devices out
as ``make_mesh((pods, data, model), ("pod", "data", "model"))``, pod
major and model minor; here the world's ranks take the same places,
rank ``r = (pod · d + data) · m + model``, and each axis is a
:class:`~repro_torch.core.dist.Group` over the ranks that share every
other coordinate:

* data groups ``{(k·d + j)·m + i : j}``, one per (pod ``k``, model ``i``);
* pod groups ``{(k·d + j)·m + i : k}``, one per (data ``j``, model ``i``);
* model groups ``{(k·d + j)·m + i : i}`` (``m > 1`` only), consecutive
  ranks.

A rank's rows of a global batch are at its dp index ``pod · d + data``
(``train.step.shard_batch``), as the reference's batch spec
``P(("pod", "data"))`` places them; the model ranks of one dp index
take the same rows.
"""
from __future__ import annotations

import torch.distributed as dist

from ..core.dist import Group

DP_AXES = ("pod", "data")
MODEL_AXIS = "model"


def make_groups(pods: int, data: int, model: int = 1,
                transport: str | None = None) -> dict:
    """``{"pod", "data"}`` Groups of this rank on a ``pods × data ×
    model`` mesh of the whole world (``pods · data · model`` ranks), and
    ``"model"`` when ``model > 1``.  Collective over the world: every
    rank calls ``dist.new_group`` for every subgroup, data groups first,
    then pod groups, then model groups, in one order, and keeps the ones
    it belongs to.  ``transport`` as in :class:`~repro_torch.core.dist.
    Group` (default: the world's)."""
    pods, data, model = int(pods), int(data), int(model)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != pods * data * model:
        raise ValueError(f"a {pods} x {data} x {model} mesh needs "
                         f"{pods * data * model} ranks, the world has "
                         f"{world}")
    axes = DP_AXES + ((MODEL_AXIS,) if model > 1 else ())
    if world == 1:
        return {ax: Group(name=ax, transport=transport) for ax in axes}
    rank = dist.get_rank()

    def at(k, j, i):
        return (k * data + j) * model + i

    layouts = (
        ("data", [[at(k, j, i) for j in range(data)]
                  for k in range(pods) for i in range(model)]),
        ("pod", [[at(k, j, i) for k in range(pods)]
                 for j in range(data) for i in range(model)]),
        (MODEL_AXIS, [[at(k, j, i) for i in range(model)]
                      for k in range(pods) for j in range(data)]
         if model > 1 else []))
    mine = {}
    for ax, member_lists in layouts:
        for members in member_lists:
            pg = dist.new_group(members)
            if rank in members:
                mine[ax] = pg
    # Group() of a cuda_ipc world checks its ranks share a host, a
    # collective over the group: every rank builds its groups in one
    # order (data, pod, model).
    out = {ax: Group(mine[ax], name=ax, transport=transport)
           for ax in ("data", "pod", MODEL_AXIS) if ax in axes}
    return {ax: out[ax] for ax in axes}


def parse_mesh(mesh: str) -> tuple[int, int, int]:
    """``(pods, data, model)`` of a ``DxM`` (``pods = 0``) or ``PxDxM``
    mesh flag.  Raises ValueError on anything else."""
    try:
        dims = [int(x) for x in mesh.split("x")]
    except ValueError:
        dims = []
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"--mesh {mesh!r}: DxM or PxDxM, sizes >= 1")
    return tuple(([0] + dims) if len(dims) == 2 else dims)


def dp_axes_of(axis_names) -> tuple:
    """The dp axes among a mesh's axis names, outermost first."""
    return tuple(n for n in axis_names if n in DP_AXES)
