"""GradientAggregator — the paper's technique as a composable module.

Counterpart of ``repro/core/aggregator.py``: fusion ∘ reduction
algorithm over the dp process groups (one per dp axis, outermost first:
``("data",)`` or ``("pod", "data")``), returning the MEAN gradient over
all ranks.  Resolution goes through :func:`repro_torch.core.schedule.
plan`, interned in a :class:`~repro_torch.core.plan_cache.PlanCache`
(the process-global one by default); ``strategy="auto"`` hands each
bucket to a :class:`~repro_torch.core.selector.Selector`.  Execution
goes through the schedule's cached :class:`~repro_torch.core.plan_cache.
StageExecutor`, which owns the fused buffers and, on ``cuda_ipc``, the
mapped receive slots, and runs each bucket stage by stage
(:func:`repro_torch.core.reducers.execute_stages`).

With a model axis (``model_axis=``, the full-manual step of
``core/manual.py``) gradients of model-sharded leaves arrive
shard-shaped and are reduced over the dp axes only; replicated buckets
of an uncoded plan take the model bracket (their dp stages on a 1/m
chunk, then an all-gather over the model group).

Two placements, as in the reference: ``__call__`` reduces a gradient
tree after backward (error feedback included), and
:meth:`GradientAggregator.overlap_params` (``overlap=True``) reduces
each bucket inside the backward, on a communication channel of its own
(:class:`OverlapRun`), whose one channel drives every axis's hops.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
import weakref
from typing import Mapping, Sequence

import torch

from .. import telemetry
from .. import tree as tree_mod
from . import codec as codec_mod
from . import dist as dist_mod
from . import overlap as overlap_mod
from . import schedule as schedule_mod
from . import selector as selector_mod
from .plan_cache import GLOBAL_EXECUTOR_CACHE, GLOBAL_PLAN_CACHE, PlanCache
from .schedule import DTYPES, ReduceSchedule


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """The reference's fields and defaults (``repro/core/aggregator.py``)."""
    strategy: str = "rhd_rsa"
    fuse: bool = True
    fusion_threshold_mb: float = 4.0
    accum_dtype: str = "float32"
    sharding_aware: bool = True
    wire_dtype: str = ""
    selector_mode: str = "analytic"
    selector_table: str = ""
    selector_link: str = "ici"
    align_buckets: bool = True
    overlap: bool = False
    codec: str = "none"
    error_feedback: bool = False
    fused_hops: "bool | None" = None

    @property
    def threshold_bytes(self) -> int:
        return int(self.fusion_threshold_mb * 2 ** 20)

    @property
    def placement(self) -> str:
        return "in_backward" if self.overlap else "post_backward"

    def validate(self):
        if self.strategy != "auto" \
                and not schedule_mod.is_strategy(self.strategy):
            raise ValueError(
                f"strategy {self.strategy!r} not in "
                f"{schedule_mod.reducers.STRATEGIES + ('auto',)} and not a "
                f"composed '<inner>{schedule_mod.SEP}<outer>' schedule name")
        if self.selector_mode not in selector_mod.MODES:
            raise ValueError(f"selector_mode {self.selector_mode!r} not in "
                             f"{selector_mod.MODES}")
        if self.strategy == "auto" and self.selector_mode == "empirical" \
                and not self.selector_table:
            raise ValueError("strategy='auto' with selector_mode="
                             "'empirical' needs selector_table=<json path>")
        if self.selector_link not in selector_mod.LINK_PROFILES:
            raise ValueError(f"selector_link {self.selector_link!r} not in "
                             f"{sorted(selector_mod.LINK_PROFILES)}")
        codec_mod.validate_spec(self.codec or "none")
        if self.error_feedback:
            if (self.codec or "none") == "none":
                raise ValueError("error_feedback=True requires a wire codec "
                                 "(codec != 'none')")
            if self.overlap:
                # The residuals are the caller's state across steps; the
                # in-backward path has nowhere to return new ones.
                raise ValueError("error_feedback is incompatible with "
                                 "overlap=True (post-backward path only)")

    def resolve_fused_hops(self) -> bool:
        """``None`` means coded schedules fuse, uncoded ones do not."""
        if self.fused_hops is None:
            return (self.codec or "none") != "none"
        return bool(self.fused_hops)

    def make_selector(self) -> "selector_mod.Selector | None":
        if self.strategy != "auto":
            return None
        wire = DTYPES[self.wire_dtype or self.accum_dtype]
        return selector_mod.make_selector(
            self.selector_mode, table=self.selector_table or None,
            link=self.selector_link, codec=self.codec or "none",
            wire_itemsize=wire.itemsize, fused=self.resolve_fused_hops())


class GradientAggregator:
    """Mean-allreduces gradient trees over the dp process groups.

    ``dp_axes`` are the dp axis names, outermost first; ``groups`` maps
    each to its :class:`~repro_torch.core.dist.Group`
    (``launch.mesh.make_groups`` builds them for a pod × data × model
    mesh), and ``model_axis``, when set, to its group too.
    ``cache`` interns resolved schedules (default: the process-global one); their stage executors
    live in the process-global executor cache.  ``last_schedule`` is the
    schedule of the last call, ``last_overlap`` the
    :class:`OverlapRecord` of the last overlapped step."""

    def __init__(self, config: AggregatorConfig, dp_axes: Sequence[str],
                 groups: Mapping[str, "dist_mod.Group"],
                 cache: PlanCache | None = None,
                 model_axis: "str | None" = None):
        config.validate()
        self.config = config
        self.dp_axes = tuple(dp_axes)
        self.model_axis = model_axis
        axes = self.dp_axes + ((model_axis,) if model_axis else ())
        missing = [a for a in axes if a not in groups]
        if missing:
            raise ValueError(f"no process group for dp axes {missing}")
        self.groups = dict(groups)
        self.cache = cache if cache is not None else GLOBAL_PLAN_CACHE
        self.selector = config.make_selector()
        self.last_schedule: ReduceSchedule | None = None
        self.last_overlap: OverlapRecord | None = None
        self._run: OverlapRun | None = None
        self._hooked: tuple | None = None     # (weakrefs, hook handles)
        self._streams: dict = {}              # device -> channel stream

    def _wire_dtype(self) -> str:
        cfg = self.config
        return cfg.wire_dtype or cfg.accum_dtype

    def resolve(self, grads, axis_sizes: Sequence[int], groups=None,
                model_axis_size: "int | None" = None) -> ReduceSchedule:
        """Resolve ``grads`` into the :class:`ReduceSchedule` IR without
        running a reduction.  With a ``model_axis``, ``model_axis_size``
        must be given and ``grads`` be shard-shaped
        (``core/manual.py::shard_param_structs``)."""
        cfg = self.config
        if not cfg.sharding_aware:
            groups = None
        if self.model_axis is not None and model_axis_size is None:
            raise ValueError(f"aggregator has model_axis="
                             f"{self.model_axis!r}; resolve needs its size")
        sched = schedule_mod.plan(
            grads, axis_names=self.dp_axes,
            axis_sizes=tuple(int(s) for s in axis_sizes),
            strategy=cfg.strategy if cfg.strategy != "auto" else "rhd_rsa",
            selector=self.selector, threshold_bytes=cfg.threshold_bytes,
            fuse=cfg.fuse, groups=groups, wire_dtype=self._wire_dtype(),
            align_buckets=cfg.align_buckets, placement=cfg.placement,
            intra=cfg.selector_link,
            codec=cfg.codec or "none",
            error_feedback=cfg.error_feedback, fused_hops=cfg.fused_hops,
            model_axis=self.model_axis,
            model_axis_size=int(model_axis_size or 1), cache=self.cache)
        self.last_schedule = sched
        if telemetry.enabled():
            tracer = telemetry.get_tracer()
            with tracer.span("aggregate.resolve", cat="trace",
                             fingerprint=sched.fingerprint(),
                             n_buckets=len(sched.buckets),
                             strategy=cfg.strategy,
                             placement=cfg.placement):
                pass
            telemetry.metrics.record_schedule(sched)
            telemetry.record_plan_cache(self.cache)
            telemetry.record_executor_cache(GLOBAL_EXECUTOR_CACHE)
        return sched

    def _context(self, grads, groups):
        sizes = tuple(self.groups[ax].size for ax in self.dp_axes)
        msize = self.groups[self.model_axis].size \
            if self.model_axis is not None else None
        sched = self.resolve(grads, sizes, groups=groups,
                             model_axis_size=msize)
        dp_size = 1
        for s in sizes:
            dp_size *= s
        return sched, 1.0 / dp_size

    def _idle(self, what: str):
        """Collectives on any dp group wait for the overlap channel."""
        if self._run is not None and self._run.active:
            raise RuntimeError(f"{what} while an overlapped backward's "
                               f"channel owns the dp groups "
                               f"{self.dp_axes}; call OverlapRun.backward "
                               f"first")

    def init_residuals(self, grads, groups=None):
        """Zero error-feedback state: one float32 buffer per bucket."""
        sched, _ = self._context(grads, groups)
        return tuple(torch.zeros(buf.shape, dtype=torch.float32,
                                 device=buf.device)
                     for buf in sched.plan.flatten(grads))

    def __call__(self, grads, groups=None, residuals=None):
        """Mean-allreduce ``grads`` (post-backward).  ``groups``: a tree
        of sharding-group tags matching ``grads``.  With ``residuals``
        returns ``(reduced_grads, new_residuals)``."""
        self._idle("aggregate")
        sched, scale = self._context(grads, groups)
        device = tree_mod.leaves(grads)[0].device
        ex = GLOBAL_EXECUTOR_CACHE.executor_for(sched, self.groups, device)
        return ex(grads, scale, residuals)

    # -- overlapped (in-backward) path --------------------------------------

    def _arm_hooks(self, leaves):
        """A post-accumulate-grad hook on every leaf, registered once
        per parameter set (a new set replaces the old hooks).  A hook
        outside an overlapped backward does nothing."""
        if self._hooked is not None:
            refs, handles = self._hooked
            if len(refs) == len(leaves) and all(
                    r() is p for r, p in zip(refs, leaves)):
                return
            for h in handles:
                h.remove()
        handles = [p.register_post_accumulate_grad_hook(
            functools.partial(self._on_grad, i))
            for i, p in enumerate(leaves)]
        self._hooked = ([weakref.ref(p) for p in leaves], handles)

    def _on_grad(self, i: int, p: torch.Tensor):
        run = self._run
        if run is not None:
            run.leaf_ready(i, p)

    def _stream(self, device):
        if device.type != "cuda":
            return None
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        return stream

    def overlap_params(self, params, groups=None) -> "OverlapRun":
        """Arm per-bucket reductions inside the next backward of
        ``params`` (the reference's ``overlap_params``; there, a
        ``jax.custom_vjp`` per bucket).  Returns an :class:`OverlapRun`
        whose :meth:`~OverlapRun.backward` runs ``loss.backward()`` and
        returns the mean-reduced gradient tree: do not also pass it
        through :meth:`__call__`.  A run armed but never run is replaced
        by the next call.

        Each leaf's post-accumulate-grad hook records an event on the
        backward's stream; when a bucket's last leaf has its gradient,
        the bucket is handed to a communication thread with a CUDA
        stream of its own, which reduces buckets strictly in the
        schedule's readiness order (every rank issues the same hops in
        the same order) through the schedule's cached
        :class:`~repro_torch.core.plan_cache.StageExecutor`, exactly as
        the post-backward path does: the same bits, at other times.
        Every ``.grad`` must be None when the backward starts.  On a
        model axis ``params`` are this rank's shards (the leaves inside
        the gather boundary, as the reference's bucket boundaries wrap
        the shard leaves), and a bracketed bucket's stages (``shard``,
        the dp hops, ``ag@model``) run on the channel too."""
        self._idle("overlap_params")
        sched, scale = self._context(params, groups)
        leaves = tree_mod.leaves(params)
        device = leaves[0].device
        # The bucket spans open later, on the channel's thread, as each
        # bucket is reduced; this one records the arming and its order.
        with telemetry.get_tracer().span(
                "overlap_params", cat="trace", n_buckets=len(sched.buckets),
                readiness_order=list(sched.readiness_order())):
            ex = GLOBAL_EXECUTOR_CACHE.executor_for(sched, self.groups,
                                                    device)
            self._arm_hooks(leaves)
            self._run = OverlapRun(self, sched, ex, params, scale,
                                   self._stream(device))
        return self._run

    def mean_scalar(self, x: torch.Tensor) -> torch.Tensor:
        """Mean of a scalar metric over the dp ranks (a psum per
        axis)."""
        self._idle("mean_scalar")
        total = x
        dp_size = 1
        for ax in self.dp_axes:
            total = dist_mod.psum(total, self.groups[ax])
            dp_size *= self.groups[ax].size
        return total / dp_size


def _timed_event(stream) -> "torch.cuda.Event":
    """A timing event recorded on ``stream`` now."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


@dataclasses.dataclass(frozen=True)
class BucketTimes:
    """One bucket on the overlap channel: host seconds from the start of
    backward to its last leaf's hook (``ready_s``), to the channel
    taking it (``start_s``) and to the channel having issued its
    reduction (``end_s``).  On the card the channel's work is queued on
    its stream, so these are issue times; ``device_start_s`` and
    ``device_end_s`` are the card's clock (CUDA events) from the start of
    backward on its stream to the bucket's work starting and ending on
    the channel's stream (None off the card)."""
    index: int
    strategy: str
    n_bytes: int
    ready_s: float
    start_s: float
    end_s: float
    device_start_s: float | None = None
    device_end_s: float | None = None


@dataclasses.dataclass(frozen=True)
class OverlapRecord:
    """One overlapped step: ``backward_s`` (host seconds until
    ``loss.backward()`` returned), the buckets in channel order, the
    bytes the transport moved meanwhile (``dist.traffic`` deltas), the
    leaves that got no gradient (reduced as zeros), ``t0``, the
    ``time.perf_counter()`` at the start of backward (the clock of the
    telemetry spans: the backward ends at ``t0 + backward_s``), and
    ``device_backward_s``, the backward on the card's clock, from an
    event recorded on its stream before ``loss.backward()`` to one
    recorded when it returned (None off the card)."""
    backward_s: float
    buckets: tuple[BucketTimes, ...]
    traffic: dict
    zero_leaves: tuple[int, ...]
    t0: float = 0.0
    device_backward_s: float | None = None

    @property
    def backward_end(self) -> float:
        """``time.perf_counter()`` when ``loss.backward()`` returned."""
        return self.t0 + self.backward_s

    def device_witness(self) -> int | None:
        """Buckets whose reduction ended on the card before the
        backward's last kernel did (None off the card)."""
        if self.device_backward_s is None:
            return None
        return sum(b.device_end_s <= self.device_backward_s
                   for b in self.buckets)

    def device_timeline(self) -> "overlap_mod.Timeline | None":
        """:meth:`timeline` on the card's clock: each bucket from its
        work's start to its end on the channel's stream, against the
        backward's span on its stream (None off the card)."""
        if self.device_backward_s is None:
            return None
        return overlap_mod.measured_timeline(
            [overlap_mod.TimelineEvent(dataclasses.replace(
                t, comm_s=b.device_end_s - b.device_start_s),
                b.device_start_s, b.device_end_s)
             for t, b in zip(self._tasks(), self.buckets)],
            self.device_backward_s)

    def _tasks(self) -> list:
        """Each bucket's task: its measured ready time, and the time from
        its start to its end as its communication time."""
        return [overlap_mod.BucketTask(
            index=b.index, n_bytes=b.n_bytes, strategy=b.strategy,
            ready_s=b.ready_s, comm_s=b.end_s - b.start_s)
            for b in self.buckets]

    def timeline(self) -> "overlap_mod.Timeline":
        """The measured timeline: each bucket from its start to its end."""
        return overlap_mod.measured_timeline(
            [overlap_mod.TimelineEvent(t, b.start_s, b.end_s)
             for t, b in zip(self._tasks(), self.buckets)], self.backward_s)

    def simulated(self) -> "overlap_mod.Timeline":
        """``overlap.simulate`` fed with the measured ready times and
        communication times."""
        return overlap_mod.simulate(self._tasks(), self.backward_s)


class OverlapRun:
    """One overlapped backward (:meth:`GradientAggregator.
    overlap_params`).  The hooks fill it; :meth:`backward` runs the
    channel and joins it.  No fallback: a hook that did not fire for a
    leaf holding a gradient, or a channel that failed, raises."""

    def __init__(self, agg: GradientAggregator, sched, executor, params,
                 scale: float, stream):
        self.agg, self.sched, self.executor = agg, sched, executor
        self.params = params
        self.leaves = tree_mod.leaves(params)
        self.scale = scale
        self.stream = stream
        self.device = self.leaves[0].device
        plan = sched.plan
        self.order = sched.readiness_order()
        self.bucket_of = {}
        for bi, b in enumerate(sched.buckets):
            for i in plan.buckets[b.index].leaf_indices:
                self.bucket_of[i] = bi
        self.missing = [len(plan.buckets[b.index].leaf_indices)
                        for b in sched.buckets]
        self.grads: list = [None] * len(self.leaves)
        self.events: list = [None] * len(self.leaves)
        self.ready_s: list = [None] * len(sched.buckets)
        self.outs: list = [None] * len(sched.buckets)
        self.done: list = [None] * len(sched.buckets)
        self.begun: list = [None] * len(sched.buckets)
        self.clock: list = []             # the backward's start and end
        self.times: list = []
        self.ran: list = []               # bucket of each of self.times
        self.cond = threading.Condition()
        self.error: BaseException | None = None
        self.abort = False
        self.t0 = None
        self.finished = False
        self.consumer = None

    @property
    def active(self) -> bool:
        """The channel runs: between the start of :meth:`backward` and
        its join."""
        return self.t0 is not None and not self.finished

    def _now(self) -> float:
        return time.perf_counter() - self.t0

    def leaf_ready(self, i: int, p: torch.Tensor):
        """Leaf ``i`` has its gradient (a hook, on the backward's
        thread and stream; or the zero fill after backward)."""
        ev = None
        if self.stream is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        with self.cond:
            if self.t0 is None:
                return                 # a backward outside run.backward
            if self.grads[i] is not None:
                self.error = self.error or RuntimeError(
                    f"leaf {i} got its gradient twice in one overlapped "
                    f"backward")
                self.cond.notify_all()
                return
            self.grads[i], self.events[i] = p.grad, ev
            b = self.bucket_of[i]
            self.missing[b] -= 1
            if self.missing[b] == 0:
                self.ready_s[b] = self._now()
                self.cond.notify_all()

    def _channel(self):
        """The communication thread: buckets in readiness order, each
        after its leaves' events, on the channel's own stream."""
        plan = self.sched.plan
        before = dict(dist_mod.traffic)
        cuda = self.stream is not None
        try:
            with torch.cuda.device(self.device) if cuda \
                    else contextlib.nullcontext(), \
                    torch.cuda.stream(self.stream) if cuda \
                    else contextlib.nullcontext():
                for bi in self.order:
                    with self.cond:
                        while self.ready_s[bi] is None and not self.abort \
                                and self.error is None:
                            self.cond.wait()
                        if self.abort or self.error is not None:
                            return
                    start = self._now()
                    idx = plan.buckets[self.sched.buckets[bi].index] \
                        .leaf_indices
                    leaves = [self.grads[i] for i in idx]
                    if cuda:
                        for i, g in zip(idx, leaves):
                            self.stream.wait_event(self.events[i])
                            g.record_stream(self.stream)
                        self.begun[bi] = _timed_event(self.stream)
                    out, _ = self.executor.reduce_bucket(bi, leaves,
                                                         self.scale)
                    if cuda:
                        out.record_stream(self.consumer)
                        self.done[bi] = _timed_event(self.stream)
                    self.outs[bi] = out
                    b = self.sched.buckets[bi]
                    self.ran.append(bi)
                    self.times.append(BucketTimes(
                        index=b.index, strategy=b.strategy,
                        n_bytes=b.n_bytes, ready_s=self.ready_s[bi],
                        start_s=start, end_s=self._now()))
        except Exception as e:           # re-raised by backward()
            with self.cond:
                self.error = e
        finally:
            self.traffic = {k: dist_mod.traffic[k] - before[k]
                            for k in before}

    def backward(self, loss: torch.Tensor):
        """``loss.backward()`` with the channel running; then the leaves
        with no gradient are reduced as zeros (JAX's cotangent for an
        unused input), the channel is joined and, on the card, its
        channels synced (``IpcChannel.sync``: the host's one wait for the
        hops, with their deadline), the current stream waits for its
        reductions, and the mean-reduced gradient tree is returned
        (``.grad`` keeps each rank's own gradient)."""
        agg = self.agg
        if agg._run is not self:
            raise RuntimeError("this OverlapRun is not the armed one")
        if any(p.grad is not None for p in self.leaves):
            raise RuntimeError("clear .grad before an overlapped backward")
        if self.stream is not None:
            self.consumer = torch.cuda.current_stream(self.device)
            self.clock = [_timed_event(self.consumer)]
        thread = threading.Thread(target=self._channel,
                                  name="overlap-channel", daemon=True)
        with self.cond:
            self.t0 = time.perf_counter()
        thread.start()
        try:
            loss.backward()
            backward_s = self._now()
            if self.stream is not None:
                self.clock.append(_timed_event(self.consumer))
            zero = []
            for i, p in enumerate(self.leaves):
                if self.grads[i] is not None:
                    continue
                if p.grad is not None:
                    raise RuntimeError(
                        f"leaf {i} holds a gradient but its hook did not "
                        f"fire: the overlapped step does not fall back to "
                        f"the post-backward path")
                p.grad = torch.zeros_like(p)
                zero.append(i)
                self.leaf_ready(i, p)
        except BaseException:
            with self.cond:
                self.abort = True
                self.cond.notify_all()
            raise
        finally:
            thread.join()
            self.finished, agg._run = True, None
        if self.error is not None:
            raise RuntimeError("the overlap channel failed") from self.error
        device_backward_s = None
        if self.stream is not None:
            # The host's one wait for the channel's hops, with the
            # channels' deadline; the card's clock can be read after it.
            for ch in self.executor.channels:
                ch.sync()
            for ev in self.done:
                self.consumer.wait_event(ev)
            for ev in (self.clock[1], *self.done):
                ev.synchronize()
            start = self.clock[0]
            device_backward_s = start.elapsed_time(self.clock[1]) / 1e3
            self.times = [dataclasses.replace(
                t, device_start_s=start.elapsed_time(self.begun[bi]) / 1e3,
                device_end_s=start.elapsed_time(self.done[bi]) / 1e3)
                for t, bi in zip(self.times, self.ran)]
        plan = self.sched.plan
        flat: list = [None] * len(self.leaves)
        for bi, b in enumerate(self.sched.buckets):
            pb = plan.buckets[b.index]
            for i, leaf in zip(pb.leaf_indices,
                               plan.unflatten_bucket(pb, self.outs[bi])):
                flat[i] = leaf
        self.executor.calls += 1
        agg.last_overlap = OverlapRecord(
            backward_s=backward_s, buckets=tuple(self.times),
            traffic=self.traffic, zero_leaves=tuple(zero), t0=self.t0,
            device_backward_s=device_backward_s)
        return tree_mod.unflatten(self.params, flat)
