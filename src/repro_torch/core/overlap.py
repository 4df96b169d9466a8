"""Overlapped gradient aggregation: the Horovod schedule, not just the
algorithm.

Counterpart of ``repro/core/overlap.py``, with its names and its
arithmetic (its results equal the reference's float for float).  The
paper (Sec. III-C / IV) credits the No-gRPC designs' win partly to WHEN
the allreduce runs: Horovod reduces fusion buckets as their gradients
become ready during backpropagation, so most communication hides under
backward compute.  Two pieces model that schedule:

1. a **bucket-readiness scheduler**: buckets ordered by reverse layer
   readiness (the last layer's gradients come first), each with a ready
   time from per-leaf backward-cost estimates;
2. a discrete-event **timeline simulator**: ready times played against
   per-bucket allreduce latencies on one serialized communication
   channel (Horovod's background thread), giving the step time, the
   overlap fraction and an idle/serialization breakdown.

The execution side is ``GradientAggregator.overlap_params``: a
post-accumulate-grad hook per leaf hands each complete bucket to a
communication thread with a CUDA stream of its own, which reduces the
buckets in :func:`readiness_order` while backward still runs.
:func:`measured_timeline` accounts for that channel's measured times
the way :func:`simulate` accounts for its own.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

# Backward share of a step's compute: backward ≈ 2x forward FLOPs, so of
# the 3x-forward total, 2/3 can overlap and 1/3 (forward + optimizer) is
# serial.
BACKWARD_FRACTION = 2.0 / 3.0


@dataclasses.dataclass(frozen=True)
class BucketTask:
    """One fusion bucket's communication task."""
    index: int            # bucket index in plan order
    n_bytes: int          # wire bytes of the fused message
    strategy: str         # resolved allreduce algorithm
    ready_s: float        # when the bucket's grads are complete
                          # (0 = backward start)
    comm_s: float         # allreduce latency


@dataclasses.dataclass(frozen=True)
class TimelineEvent:
    task: BucketTask
    start_s: float
    end_s: float

    @property
    def wait_s(self) -> float:
        """Time the bucket sat ready while the channel was busy."""
        return self.start_s - self.task.ready_s


@dataclasses.dataclass(frozen=True)
class Timeline:
    """Bucket ready times played against one serialized channel."""
    events: tuple[TimelineEvent, ...]
    backward_s: float     # overlappable compute span (t=0 .. backward_s)
    serial_s: float       # non-overlappable compute (forward + optimizer)
    comm_s: float         # total communication latency
    hidden_comm_s: float  # communication under the backward span
    exposed_comm_s: float # communication past the backward span
    idle_s: float         # channel idle between events (buckets not
                          # ready yet)

    @property
    def step_s(self) -> float:
        end = self.events[-1].end_s if self.events else 0.0
        return self.serial_s + max(self.backward_s, end)

    @property
    def overlap_fraction(self) -> float:
        """Share of communication hidden under backward compute (1.0
        when there is no communication)."""
        if self.comm_s <= 0.0:
            return 1.0
        return self.hidden_comm_s / self.comm_s

    def to_dict(self) -> dict:
        return {
            "backward_s": self.backward_s,
            "serial_s": self.serial_s,
            "comm_s": self.comm_s,
            "hidden_comm_s": self.hidden_comm_s,
            "exposed_comm_s": self.exposed_comm_s,
            "idle_s": self.idle_s,
            "step_s": self.step_s,
            "overlap_fraction": self.overlap_fraction,
            "n_buckets": len(self.events),
        }


# ---------------------------------------------------------------------------
# Bucket-readiness scheduler
# ---------------------------------------------------------------------------

def leaf_backward_costs(leaves) -> tuple[float, ...]:
    """Per-leaf backward-cost weights from the fusion plan's LeafMeta:
    proportional to the element count (a matmul weight of n elements
    costs ~4·n·tokens in its dW and dx products); empty leaves weigh 1."""
    return tuple(float(max(m.size, 1)) for m in leaves)


def bucket_ready_times(plan, backward_s: float,
                       costs: Sequence[float] | None = None
                       ) -> tuple[float, ...]:
    """Ready time per bucket (plan order), with backward visiting leaves
    in REVERSE traversal order and spending time proportional to each
    leaf's cost: a bucket is ready when its minimum-index leaf is."""
    costs = tuple(costs) if costs is not None \
        else leaf_backward_costs(plan.leaves)
    if len(costs) != len(plan.leaves):
        raise ValueError(f"{len(costs)} costs for {len(plan.leaves)} leaves")
    total = sum(costs) or 1.0
    completion = [0.0] * len(costs)
    acc = 0.0
    for j in range(len(costs) - 1, -1, -1):
        acc += costs[j]
        completion[j] = backward_s * acc / total
    return tuple(completion[min(b.leaf_indices)] for b in plan.buckets)


def readiness_order(plan) -> tuple[int, ...]:
    """Bucket indices ordered earliest-ready first: descending minimum
    leaf index (backward produces high-index leaves' grads first)."""
    return tuple(sorted(range(len(plan.buckets)),
                        key=lambda i: -min(plan.buckets[i].leaf_indices)))


# ---------------------------------------------------------------------------
# Discrete-event timeline simulator
# ---------------------------------------------------------------------------

def measured_timeline(events: Sequence[TimelineEvent], backward_s: float,
                      serial_s: float = 0.0) -> Timeline:
    """The :class:`Timeline` of ``events`` in channel order, with
    :func:`simulate`'s accounting: communication inside [0,
    ``backward_s``] is hidden, the rest exposed, gaps between events
    idle.  Fed with a channel's measured start and end times (each
    task's ``comm_s`` = end − start), it gives the measured overlap."""
    free = 0.0
    hidden = exposed = idle = comm = 0.0
    for i, e in enumerate(events):
        if i:
            idle += max(0.0, e.start_s - free)
        comm += e.task.comm_s
        exposed += max(0.0, e.end_s - max(e.start_s, backward_s))
        free = e.end_s
    exposed = min(exposed, comm)      # clamp float residue of the split
    hidden = max(0.0, comm - exposed)
    return Timeline(events=tuple(events), backward_s=backward_s,
                    serial_s=serial_s, comm_s=comm, hidden_comm_s=hidden,
                    exposed_comm_s=exposed, idle_s=idle)


def simulate(tasks: Sequence[BucketTask], backward_s: float,
             serial_s: float = 0.0) -> Timeline:
    """Play ``tasks`` against one serialized communication channel:
    FIFO on ``ready_s``, each allreduce starting when its bucket is
    ready and the channel free.  ``serial_s`` (forward + optimizer) adds
    to the step but never overlaps communication."""
    ordered = sorted(tasks, key=lambda t: (t.ready_s, t.index))
    events = []
    free = 0.0
    for t in ordered:
        start = max(t.ready_s, free)
        end = start + t.comm_s
        events.append(TimelineEvent(task=t, start_s=start, end_s=end))
        free = end
    return measured_timeline(events, backward_s, serial_s)


def schedule_tasks(sched, backward_s: float,
                   costs: Sequence[float] | None = None
                   ) -> list[BucketTask]:
    """BucketTasks (plan order) for a resolved ReduceSchedule.  An
    attached schedule takes ready times from its fusion plan's per-leaf
    costs; a detached one from bucket sizes in readiness order."""
    if sched.plan is not None:
        ready = bucket_ready_times(sched.plan, backward_s, costs=costs)
    else:
        total = sum(max(b.size, 1) for b in sched.buckets) or 1.0
        ready_by_rank = {}
        acc = 0.0
        for bi in sched.readiness_order():
            acc += max(sched.buckets[bi].size, 1)
            ready_by_rank[bi] = backward_s * acc / total
        ready = [ready_by_rank[i] for i in range(len(sched.buckets))]
    return [BucketTask(index=b.index, n_bytes=b.n_bytes,
                       strategy=b.strategy, ready_s=ready[i],
                       comm_s=float(b.predicted_s))
            for i, b in enumerate(sched.buckets)]


def simulate_schedule(sched, compute_s: float,
                      backward_fraction: float = BACKWARD_FRACTION,
                      costs: Sequence[float] | None = None) -> Timeline:
    """Timeline for a resolved ReduceSchedule: ``compute_s`` split into
    an overlappable backward span and a serial remainder."""
    backward_s = compute_s * backward_fraction
    tasks = schedule_tasks(sched, backward_s, costs=costs)
    return simulate(tasks, backward_s,
                    serial_s=compute_s * (1.0 - backward_fraction))


# ---------------------------------------------------------------------------
# Synthetic model timelines (no FusionPlan in hand)
# ---------------------------------------------------------------------------

def fused_bucket_bytes(total_bytes: float, n_variables: int,
                       threshold_bytes: float) -> list[float]:
    """Greedy first-fit fusion of ``n_variables`` equal-size gradients."""
    if n_variables <= 0:
        return []
    var = total_bytes / n_variables
    if threshold_bytes <= 0 or var >= threshold_bytes:
        return [var] * n_variables
    buckets = []
    cur = 0.0
    for _ in range(n_variables):
        if cur + var > threshold_bytes and cur > 0:
            buckets.append(cur)
            cur = 0.0
        cur += var
    if cur > 0:
        buckets.append(cur)
    return buckets


def model_tasks(total_bytes: float, n_variables: int,
                threshold_bytes: float, backward_s: float,
                latency_fn: Callable[[float], float],
                strategy: str = "?") -> list[BucketTask]:
    """BucketTasks for an analytic model: equal-size variables fused
    greedily, ready uniformly through the backward in reverse order
    (bucket 0, the first layers, ready last)."""
    sizes = fused_bucket_bytes(total_bytes, n_variables, threshold_bytes)
    total = sum(sizes) or 1.0
    tasks = []
    acc = 0.0
    for i, b in zip(range(len(sizes) - 1, -1, -1), reversed(sizes)):
        acc += b
        tasks.append(BucketTask(index=i, n_bytes=int(b), strategy=strategy,
                                ready_s=backward_s * acc / total,
                                comm_s=float(latency_fn(b))))
    return tasks


def model_timeline(total_bytes: float, n_variables: int,
                   threshold_bytes: float, compute_s: float,
                   latency_fn: Callable[[float], float],
                   strategy: str = "?",
                   backward_fraction: float = BACKWARD_FRACTION
                   ) -> Timeline:
    """Timeline for an analytic model configuration, per-bucket latency
    from ``latency_fn``."""
    backward_s = compute_s * backward_fraction
    tasks = model_tasks(total_bytes, n_variables, threshold_bytes,
                        backward_s, latency_fn, strategy=strategy)
    return simulate(tasks, backward_s,
                    serial_s=compute_s * (1.0 - backward_fraction))
