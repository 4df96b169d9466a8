"""Tensor Fusion — Horovod's bucketing, as a pure layout object.

Counterpart of ``repro/core/fusion.py`` with the same packing rule:
greedy first-fit in leaf order within each (dtype, sharding-group)
class; leaves at or above the threshold, and leaves whose group tag is
sharded, stay single-leaf buckets with their rank preserved, so the
reducers chunk them along the leading dim exactly as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Hashable, Sequence

import torch

from .. import tree as tree_mod


@dataclasses.dataclass(frozen=True)
class LeafMeta:
    index: int
    shape: tuple[int, ...]
    dtype: Any
    group: Hashable

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class Bucket:
    leaf_indices: tuple[int, ...]
    dtype: Any
    group: Hashable
    size: int


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    like: Any                  # the tree's structure, leaves set to None
    leaves: tuple[LeafMeta, ...]
    buckets: tuple[Bucket, ...]
    threshold_bytes: int
    switch_points: tuple[int, ...] = ()

    def flatten_bucket(self, bucket: Bucket, leaves: Sequence[torch.Tensor],
                       out: torch.Tensor | None = None) -> torch.Tensor:
        """One bucket's fused buffer: a single leaf as it is (at least
        1-d), several concatenated.  With ``out`` the leaves are written
        into it instead (cast to its dtype) and ``out`` is returned."""
        if len(bucket.leaf_indices) == 1:
            leaf = leaves[0]
            if out is not None:
                return out.copy_(leaf.reshape(out.shape))
            return leaf if leaf.ndim >= 1 else leaf.reshape(1)
        return torch.cat([x.reshape(-1) for x in leaves], out=out)

    def unflatten_bucket(self, bucket: Bucket,
                         buf: torch.Tensor) -> list[torch.Tensor]:
        if len(bucket.leaf_indices) == 1:
            return [buf.reshape(self.leaves[bucket.leaf_indices[0]].shape)]
        out, off = [], 0
        for i in bucket.leaf_indices:
            m = self.leaves[i]
            out.append(buf[off:off + m.size].reshape(m.shape))
            off += m.size
        return out

    def flatten(self, tree, out=None) -> list[torch.Tensor]:
        """tree -> one fused buffer per bucket.  ``out``: one buffer (or
        None, for a fresh one) per bucket to write into."""
        flat = tree_mod.leaves(tree)
        out = [None] * len(self.buckets) if out is None else out
        return [self.flatten_bucket(b, [flat[i] for i in b.leaf_indices], o)
                for b, o in zip(self.buckets, out)]

    def unflatten(self, buffers: Sequence[torch.Tensor]):
        flat: list = [None] * len(self.leaves)
        for b, buf in zip(self.buckets, buffers):
            for i, leaf in zip(b.leaf_indices, self.unflatten_bucket(b, buf)):
                flat[i] = leaf
        return tree_mod.unflatten(self.like, flat)


def chunk_axis(group, ndim: int) -> int:
    """The dim a bucket's reducers chunk: the first unsharded dim of a
    leaf whose fusion-group tag is its tuple-ized PartitionSpec (None
    entries = unsharded), else 0."""
    if not isinstance(group, tuple) or ndim == 0:
        return 0
    for i in range(ndim):
        if i >= len(group) or group[i] is None:
            return i
    return 0


def _replicated(tag) -> bool:
    return tag is None or (isinstance(tag, tuple)
                           and all(t is None for t in tag))


def build_plan(tree, threshold_bytes: int, groups=None, fuse: bool = True,
               switch_points: Sequence[int] | None = None,
               switch_itemsize: int = 0) -> FusionPlan:
    """Bucket the leaves of ``tree`` (anything with ``.shape`` and a
    torch ``.dtype``).  ``groups``: a tree of the same structure holding
    sharding-group tags (tuples; None = replicated).

    ``switch_points``: ascending byte sizes at which the selector's
    chosen algorithm changes.  A fused bucket is never grown across one:
    if a leaf would carry it from below a switch point to above, the
    bucket is closed first, so each fused message sits inside one
    algorithm regime (a single leaf larger than a switch point is
    bucketed as usual).  ``switch_itemsize``: the element size the
    switch points are counted in, the WIRE dtype's, which is what the
    selector sees; crossing is then judged on element counts times it.
    0 compares leaf bytes."""
    switch = tuple(sorted(int(s) for s in switch_points)) \
        if switch_points else ()

    def _crosses(cur: dict, m: LeafMeta) -> bool:
        if switch_itemsize:
            a, b = cur["size"] * switch_itemsize, m.size * switch_itemsize
        else:
            a, b = cur["bytes"], m.nbytes
        return any(a < s < a + b for s in switch)

    flat = tree_mod.leaves(tree)
    tags = [None] * len(flat) if groups is None else tree_mod.leaves(groups)
    if len(tags) != len(flat):
        raise ValueError("groups tree must match gradient tree")
    leaves = tuple(LeafMeta(i, tuple(int(d) for d in x.shape), x.dtype,
                            tags[i])
                   for i, x in enumerate(flat))

    buckets: list[Bucket] = []
    if not fuse:
        buckets = [Bucket((m.index,), m.dtype, m.group, m.size)
                   for m in leaves]
    else:
        open_buckets: dict = {}
        for m in leaves:
            key = (m.dtype, m.group)
            if m.nbytes >= threshold_bytes or not _replicated(m.group):
                buckets.append(Bucket((m.index,), m.dtype, m.group, m.size))
                continue
            cur = open_buckets.get(key)
            if cur is not None \
                    and cur["bytes"] + m.nbytes <= threshold_bytes \
                    and not _crosses(cur, m):
                cur["idx"].append(m.index)
                cur["bytes"] += m.nbytes
                cur["size"] += m.size
            else:
                if cur is not None:
                    buckets.append(Bucket(tuple(cur["idx"]), key[0], key[1],
                                          cur["size"]))
                open_buckets[key] = {"idx": [m.index], "bytes": m.nbytes,
                                     "size": m.size}
        for key, cur in open_buckets.items():
            buckets.append(Bucket(tuple(cur["idx"]), key[0], key[1],
                                  cur["size"]))
    return FusionPlan(like=tree_mod.tree_map(lambda _: None, tree),
                      leaves=leaves, buckets=tuple(buckets),
                      threshold_bytes=threshold_bytes, switch_points=switch)
