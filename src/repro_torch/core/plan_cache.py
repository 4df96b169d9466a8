"""Plan cache and stage executors: the paper's Pointer Cache, in torch.

Counterpart of ``repro/core/plan_cache.py``, with its names.  Paper
(Sec. V-B): every CUDA-aware MPI call asked the CUDA driver what kind of
buffer a pointer was, and that query sat on the critical path of every
primitive; the fix cached the answer.

:class:`PlanCache` interns resolved :class:`~repro_torch.core.schedule.
ReduceSchedule` s (and raw :class:`~repro_torch.core.fusion.FusionPlan`
s) keyed by the gradient tree's structure, shapes, dtypes and group tags
and the whole resolution context, so a stale plan is impossible by
construction and a step does no layout work after the first.

:class:`StageExecutor` is the pointer cache extended to the reduction
itself.  Built once per key, it owns what a step would otherwise
allocate or look up again: one fused buffer per bucket that needs one,
in the wire/accumulation dtype (the aggregator flattens into it), and,
on each ``cuda_ipc`` axis (the dp axes, and the model axis of a
bracketed schedule), the :class:`~repro_torch.core.dist.IpcChannel`
whose receive slots the peers have mapped once, sized to that axis's
largest hop.  ``traces`` counts
builds (buffer allocation plus the handle exchange): a cached
executor's second call leaves it at 1.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Hashable

import torch

from .. import tree as tree_mod
from ..telemetry import trace as telemetry_trace
from . import codec as codec_mod
from . import dist as dist_mod
from . import fusion, reducers
from .schedule import DTYPES, _tree_meta


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    # ``cache.stats()`` (the snapshot) and ``cache.stats.hits`` (the
    # counters) are the same attribute: calling it asks the owner.
    _cache: "PlanCache | StageExecutorCache" = dataclasses.field(
        kw_only=True, repr=False, compare=False)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __call__(self) -> dict:
        return self._cache.stats_snapshot()


class PlanCache:
    """Interns plans by key.  Concurrent misses of one key build once
    (a per-key build lock; the loser records a hit), and a build that a
    :meth:`clear` overtook is handed to its caller but not interned, so
    ``builds`` equals ``misses``, key by key."""

    def __init__(self):
        self._plans: dict[Hashable, object] = {}
        self._lock = threading.Lock()
        self._build_locks: dict[Hashable, threading.Lock] = {}
        self._generation = 0
        self.stats = CacheStats(_cache=self)
        self._builds: dict[str, int] = {}

    @staticmethod
    def _key_id(key: Hashable) -> str:
        return f"{hash(key) & 0xffffffffffff:012x}"

    @staticmethod
    def key_for(tree, threshold_bytes: int, groups, fuse: bool) -> Hashable:
        return _tree_meta(tree, groups) + (threshold_bytes, fuse)

    def _get_or_build(self, key: Hashable, builder):
        while True:
            with self._lock:
                plan = self._plans.get(key)
                if plan is not None:
                    self.stats.hits += 1
                    return plan
                build_lock = self._build_locks.setdefault(
                    key, threading.Lock())
            with build_lock:
                with self._lock:
                    if self._build_locks.get(key) is not build_lock:
                        continue       # the builder we waited on retired it
                    plan = self._plans.get(key)
                    if plan is not None:
                        self.stats.hits += 1
                        return plan
                    generation = self._generation
                try:
                    plan = builder()
                    with self._lock:
                        if self._generation == generation:
                            self._plans[key] = plan
                            self.stats.misses += 1
                            kid = self._key_id(key)
                            self._builds[kid] = self._builds.get(kid, 0) + 1
                finally:
                    with self._lock:
                        if self._build_locks.get(key) is build_lock:
                            del self._build_locks[key]
            return plan

    def get_or_build(self, tree, threshold_bytes: int, groups=None,
                     fuse: bool = True) -> fusion.FusionPlan:
        """Raw FusionPlan interning (layout only).  The aggregator goes
        through :meth:`resolve`."""
        key = self.key_for(tree, threshold_bytes, groups, fuse)
        return self._get_or_build(key, lambda: fusion.build_plan(
            tree, threshold_bytes, groups=groups, fuse=fuse))

    def resolve(self, request, builder):
        """Intern a resolved schedule under its
        :class:`~repro_torch.core.schedule.ScheduleRequest` fingerprint."""
        return self._get_or_build(("schedule", request.fingerprint()),
                                  builder)

    def stats_snapshot(self) -> dict:
        with self._lock:
            return {"hits": self.stats.hits, "misses": self.stats.misses,
                    "hit_rate": self.stats.hit_rate,
                    "interned": len(self._plans),
                    "n_builds": sum(self._builds.values()),
                    "builds": dict(self._builds)}

    def clear(self):
        with self._lock:
            self._plans.clear()
            self._generation += 1
            self.stats = CacheStats(_cache=self)
            self._builds = {}

    def __len__(self):
        return len(self._plans)


# ---------------------------------------------------------------------------
# Stage executors
# ---------------------------------------------------------------------------

def _buffer_specs(sched) -> tuple:
    """``(shape, dtype)`` of each bucket's fused buffer as the executor
    holds it: a single leaf keeps its shape (at least 1-d), several are
    concatenated flat.  The dtype is the wire/accumulation dtype, except
    under error feedback, which quantizes in the leaves' own dtype."""
    plan = sched.plan
    accum = DTYPES[sched.wire_dtype]
    specs = []
    for b in plan.buckets:
        if len(b.leaf_indices) == 1:
            shape = plan.leaves[b.leaf_indices[0]].shape or (1,)
        else:
            shape = (b.size,)
        dtype = b.dtype if sched.error_feedback else accum
        specs.append((tuple(shape), dtype))
    return tuple(specs)


def stage_slot_bytes(st, shape, itemsize: int) -> int:
    """The receive slot one stage ``st`` needs on its axis for a buffer
    of ``shape`` whose uncoded elements take ``itemsize`` bytes: its
    largest hop (coded: the codec's payload and the most scales a hop
    carries) or its all-gather row."""
    hop, row = reducers.hop_elements(st.algorithm, shape, st.axis_size,
                                     op=st.op)
    c = codec_mod.get(st.codec or "none")
    if c.name == "none":
        parts = [hop * itemsize]
    else:
        scales = reducers.hop_scales(st.algorithm, st.axis_size)
        parts = [hop * c.itemsize] + (
            [codec_mod.SCALE_BYTES * scales] if c.scaled else [])
    return max(dist_mod.slot_bytes(parts) if hop else 0, row * itemsize)


def _slot_bytes(sched, specs) -> dict:
    """Per axis, the largest hop payload of ``sched``'s stages on that
    axis (coded: the codec's payload and the most scales a hop carries;
    uncoded: the buffer's dtype, float32 wherever a bucket carries a
    codec), the size of that axis's receive slots.  Each stage sees the
    buffer its predecessors leave: a reduce-scatter's chunk, the rows
    restored by its all-gather."""
    accum = DTYPES[sched.wire_dtype]
    plan = sched.plan
    need = {ax: 0 for ax in _axes(sched)}
    for bucket, (shape, _) in zip(sched.buckets, specs):
        axis = fusion.chunk_axis(plan.buckets[bucket.index].group, len(shape))
        shape = (shape[axis],) + shape[:axis] + shape[axis + 1:]
        coded = any(st.codec != "none" for st in bucket.stages)
        itemsize = 4 if coded else accum.itemsize
        pending = []
        for st in bucket.stages:
            need[st.axis] = max(need[st.axis],
                                stage_slot_bytes(st, shape, itemsize))
            if st.op in ("reduce_scatter", "shard"):
                pending.append(shape)
                shape = (-(-shape[0] // st.axis_size),) + shape[1:]
            elif st.op == "all_gather":
                shape = pending.pop()
    return need


def _axes(sched) -> tuple:
    """The axes ``sched``'s stages run on: its dp axes, then the model
    axis of a bracketed schedule."""
    return sched.axis_names + ((sched.model_axis,) if sched.bracketed
                               else ())


class StageExecutor:
    """One resolved schedule, built once: its fused buffers and, on
    ``cuda_ipc``, a channel per axis (the model bracket's axis too).
    ``executor(tree, scale, residuals)`` mean-reduces a gradient tree
    bucket by bucket.

    Each bucket that must be packed or cast is flattened into the
    executor's own buffer, reused every call (the reference's donated
    inputs); a single leaf already in the accumulation dtype is reduced
    from where it lies.  ``traces`` counts builds; ``calls`` counts
    trees reduced."""

    def __init__(self, sched, groups, device):
        if sched.plan is None:
            raise ValueError("StageExecutor needs an attached schedule "
                             "(plan is None)")
        self.schedule = sched
        self.device = torch.device(device)
        self.traces = 0
        self.calls = 0
        self.buffers: list = []
        self.channels: list = []
        self.groups = {ax: groups[ax] for ax in _axes(sched)}
        self._build()

    def _build(self):
        self.traces += 1
        sched, plan = self.schedule, self.schedule.plan
        specs = _buffer_specs(sched)
        self.buffers = [
            torch.empty(shape, dtype=dtype, device=self.device)
            if len(b.leaf_indices) > 1 or b.dtype != dtype
            else None
            for b, (shape, dtype) in zip(plan.buckets, specs)]
        slots = _slot_bytes(sched, specs)
        # One channel per axis, opened in the schedule's axis order on
        # every rank: opening is collective over the axis's group.
        for ax, g in self.groups.items():
            if g.transport == "cuda_ipc" and g.size > 1 and slots[ax]:
                ch = dist_mod.IpcChannel(g, slots[ax], self.device)
                self.channels.append(ch)
                self.groups[ax] = ch.group

    def _reduce_bucket(self, bucket, tag, buf, scale, residual):
        """One bucket: error feedback (``q(g + r)``, in the leaves'
        dtype), cast to the wire/accumulation dtype, the stages, the
        mean scale, cast back."""
        accum = DTYPES[self.schedule.wire_dtype]
        orig = self.schedule.plan.buckets[bucket.index].dtype
        new_residual = None
        if residual is not None:
            cname = next((st.codec for st in bucket.stages
                          if st.codec != "none"), "none")
            if cname != "none":
                buf, new_residual = codec_mod.ef_quantize(cname, buf,
                                                          residual)
                buf = buf.to(orig)
            else:
                new_residual = residual
        if buf.dtype != accum:
            buf = buf.to(accum)
        axis = fusion.chunk_axis(tag, buf.ndim)
        if axis != 0:
            buf = torch.movedim(buf, axis, 0).contiguous()
        buf = reducers.execute_stages(buf, bucket.stages, self.groups)
        if axis != 0:
            buf = torch.movedim(buf, 0, axis)
        return (buf * scale).to(orig), new_residual

    def _check_open(self):
        if self.channels and self.channels[0].closed:
            raise RuntimeError("StageExecutor: its channel is closed")

    def reduce_bucket(self, i: int, leaves, scale: float = 1.0,
                      residual=None):
        """Reduce bucket ``i`` of the schedule from its ``leaves`` (in
        the bucket's leaf order): flatten into the executor's buffer,
        then the stages.  Returns ``(reduced buffer, new residual)``; the
        in-backward channel calls it bucket by bucket, :meth:`__call__`
        for every bucket of a tree, so both reduce the same bits."""
        self._check_open()
        plan, bucket = self.schedule.plan, self.schedule.buckets[i]
        pb = plan.buckets[bucket.index]
        with telemetry_trace.get_tracer().span(
                bucket.path, cat="trace", ir_path=bucket.path,
                strategy=bucket.strategy, size=bucket.size,
                n_bytes=bucket.n_bytes, wire_bytes=bucket.wire_bytes,
                readiness_rank=bucket.readiness_rank,
                placement=self.schedule.placement,
                error_feedback=residual is not None):
            buf = plan.flatten_bucket(pb, leaves,
                                      self.buffers[bucket.index])
            return self._reduce_bucket(bucket, pb.group, buf, scale,
                                       residual)

    def __call__(self, tree, scale: float = 1.0, residuals=None):
        """Reduce ``tree`` (laid out as the schedule's plan) and scale it
        by ``scale``.  With ``residuals`` (one per bucket) returns
        ``(reduced_tree, new_residuals)``."""
        self._check_open()
        plan = self.schedule.plan
        if residuals is not None and len(residuals) != len(plan.buckets):
            raise ValueError(
                f"{len(residuals)} residual buffers for "
                f"{len(plan.buckets)} fusion buckets — pass "
                f"init_residuals() output")
        flat = tree_mod.leaves(tree)
        self.calls += 1
        reduced, new_residuals = [], []
        with telemetry_trace.get_tracer().span(
                "aggregate", cat="trace", n_buckets=len(plan.buckets),
                placement=self.schedule.placement):
            for i, bucket in enumerate(self.schedule.buckets):
                out, r = self.reduce_bucket(
                    i, [flat[j] for j in
                        plan.buckets[bucket.index].leaf_indices],
                    scale, None if residuals is None else residuals[i])
                reduced.append(out)
                new_residuals.append(r)
            # The aggregate's end: the host waits here for its hops on
            # the card (with the channels' deadline) and checks them.
            for ch in self.channels:
                ch.sync()
        if residuals is not None:
            return plan.unflatten(reduced), tuple(new_residuals)
        return plan.unflatten(reduced)

    def close(self):
        """Release the buffers and close the channels (collective)."""
        for ch in self.channels:
            ch.close()
        self.buffers = []


class StageExecutorCache:
    """Interns :class:`StageExecutor` s.  The key is the whole execution
    identity: the schedule's fingerprint, every leaf's shape and dtype
    and every bucket's buffer and group tag, and the codec; in place of
    the reference's mesh, the groups' sizes, global ranks and transports
    and the device.  (An executor always owns its buffers, so the
    reference's ``donate`` has no counterpart.)"""

    def __init__(self):
        self._executors: dict[Hashable, StageExecutor] = {}
        self._lock = threading.Lock()
        self.stats = CacheStats(_cache=self)

    @staticmethod
    def key_for(sched, groups, device) -> Hashable:
        plan = sched.plan
        leaves = tuple((m.shape, str(m.dtype)) for m in plan.leaves)
        specs = tuple((shape, str(dtype))
                      for shape, dtype in _buffer_specs(sched))
        tags = tuple(b.group for b in plan.buckets)
        gkey = tuple((ax, g.size, tuple(map(g.global_rank, range(g.size))),
                      g.transport)
                     for ax, g in ((a, groups[a]) for a in _axes(sched)))
        return (sched.fingerprint(), leaves, specs, tags,
                sched.codec or "none", gkey, str(torch.device(device)))

    def executor_for(self, sched, groups, device) -> StageExecutor:
        """The cached executor of ``sched`` over ``groups`` (axis name to
        :class:`~repro_torch.core.dist.Group`) on ``device``.  A build on
        a ``cuda_ipc`` group is collective: every rank of the group must
        ask for the same key at the same point."""
        key = self.key_for(sched, groups, device)
        with self._lock:
            ex = self._executors.get(key)
            if ex is not None:
                self.stats.hits += 1
                return ex
        ex = StageExecutor(sched, groups, device)
        with self._lock:
            self._executors[key] = ex
            self.stats.misses += 1
        return ex

    def stats_snapshot(self) -> dict:
        with self._lock:
            exs = list(self._executors.values())
            return {"hits": self.stats.hits, "misses": self.stats.misses,
                    "hit_rate": self.stats.hit_rate, "interned": len(exs),
                    "traces": sum(e.traces for e in exs),
                    "calls": sum(e.calls for e in exs)}

    def clear(self):
        """Forget every executor and close its channels: collective on
        every group an executor holds a channel of."""
        with self._lock:
            exs = list(self._executors.values())
            self._executors.clear()
            self.stats = CacheStats(_cache=self)
        for ex in exs:
            ex.close()

    def __len__(self):
        return len(self._executors)


# Process-global caches, as the MPI runtime's pointer cache is global.
GLOBAL_PLAN_CACHE = PlanCache()
GLOBAL_EXECUTOR_CACHE = StageExecutorCache()
