"""GradientAggregator — the paper's technique as a composable module.

Counterpart of ``repro/core/aggregator.py``: fusion ∘ reduction
algorithm, applied post-backward to a gradient tree over the data
process group, returning the MEAN gradient over all ranks.  Resolution
goes through :func:`repro_torch.core.schedule.plan`, interned in a
:class:`~repro_torch.core.plan_cache.PlanCache` (the process-global one
by default); execution goes through the schedule's cached
:class:`~repro_torch.core.plan_cache.StageExecutor`, which owns the
fused buffers and, on ``cuda_ipc``, the mapped receive slots, and runs
each bucket stage by stage (:func:`repro_torch.core.reducers.
execute_stages`).

This slice covers the post-backward path on one data axis, with every
codec, the fused-hop default and error feedback.  ``overlap=True`` and
``strategy="auto"`` raise ``NotImplementedError`` until a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from .. import tree as tree_mod
from . import codec as codec_mod
from . import dist as dist_mod
from . import schedule as schedule_mod
from .plan_cache import GLOBAL_EXECUTOR_CACHE, GLOBAL_PLAN_CACHE, PlanCache
from .schedule import ReduceSchedule


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
        if self.strategy == "auto":
            raise NotImplementedError(
                "strategy='auto' (the selector) is not ported yet")
        if self.overlap:
            raise NotImplementedError(
                "overlap=True (in-backward reductions) is not ported yet")
        schedule_mod.normalize_strategy(self.strategy, 1)
        codec_mod.validate_spec(self.codec or "none")
        if self.error_feedback and (self.codec or "none") == "none":
            raise ValueError("error_feedback=True requires a wire codec "
                             "(codec != 'none')")

    def resolve_fused_hops(self) -> bool:
        """``None`` means coded schedules fuse, uncoded ones do not."""
        if self.fused_hops is None:
            return (self.codec or "none") != "none"
        return bool(self.fused_hops)


class GradientAggregator:
    """Mean-allreduces gradient trees over the data process group(s).

    ``groups`` maps each name of ``dp_axes`` to its
    :class:`~repro_torch.core.dist.Group`.  ``cache`` interns resolved
    schedules (default: the process-global one); their stage executors
    live in the process-global executor cache."""

    def __init__(self, config: AggregatorConfig, dp_axes: Sequence[str],
                 groups: Mapping[str, "dist_mod.Group"],
                 cache: PlanCache | None = None):
        config.validate()
        self.config = config
        self.dp_axes = tuple(dp_axes)
        if len(self.dp_axes) != 1:
            raise NotImplementedError(
                f"dp axes {self.dp_axes}: multi-axis aggregation is not "
                f"ported yet")
        missing = [a for a in self.dp_axes if a not in groups]
        if missing:
            raise ValueError(f"no process group for dp axes {missing}")
        self.groups = dict(groups)
        self.cache = cache if cache is not None else GLOBAL_PLAN_CACHE
        self.last_schedule: ReduceSchedule | None = None

    def _wire_dtype(self) -> str:
        cfg = self.config
        return cfg.wire_dtype or cfg.accum_dtype

    def resolve(self, grads, axis_sizes: Sequence[int],
                groups=None) -> ReduceSchedule:
        """Resolve ``grads`` into the :class:`ReduceSchedule` IR without
        running a reduction."""
        cfg = self.config
        if not cfg.sharding_aware:
            groups = None
        sched = schedule_mod.plan(
            grads, axis_names=self.dp_axes,
            axis_sizes=tuple(int(s) for s in axis_sizes),
            strategy=cfg.strategy, threshold_bytes=cfg.threshold_bytes,
            fuse=cfg.fuse, groups=groups, wire_dtype=self._wire_dtype(),
            placement=cfg.placement, intra=cfg.selector_link,
            codec=cfg.codec or "none", error_feedback=cfg.error_feedback,
            fused_hops=cfg.fused_hops, cache=self.cache)
        self.last_schedule = sched
        return sched

    def _context(self, grads, groups):
        sizes = tuple(self.groups[ax].size for ax in self.dp_axes)
        sched = self.resolve(grads, sizes, groups=groups)
        dp_size = 1
        for s in sizes:
            dp_size *= s
        return sched, 1.0 / dp_size

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
        sched, scale = self._context(grads, groups)
        device = tree_mod.leaves(grads)[0].device
        ex = GLOBAL_EXECUTOR_CACHE.executor_for(sched, self.groups, device)
        return ex(grads, scale, residuals)

    def mean_scalar(self, x: torch.Tensor) -> torch.Tensor:
        """Mean of a scalar metric over the data ranks."""
        total = x
        dp_size = 1
        for ax in self.dp_axes:
            total = dist_mod.psum(total, self.groups[ax])
            dp_size *= self.groups[ax].size
        return total / dp_size
