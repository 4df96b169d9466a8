"""The characterization experiment matrix — the paper's grid as data.

Counterpart of ``repro/experiments/matrix.py``.  Every application-level
figure of the paper is a walk over the same four axes:

    design ∈ {gRPC_PS, Baidu_ring, Horovod_NCCL2, Horovod_MPI,
              Horovod_MPI_Opt}
  × model  ∈ {resnet50, mobilenet, nasnet-large}
  × p      ∈ {1, 2, 4, ..., 64, 128}
  × per-device batch ∈ {16, 32, 64}

:func:`grid` builds :class:`ExperimentPoint` lists and :func:`run_matrix`
evaluates them on the analytic (``model``) backend: per-design bucket
latencies from :mod:`repro_torch.core.cost_model` played through the
overlap simulator (:mod:`repro_torch.core.overlap`), for any p.  Each
cell resolves a detached ReduceSchedule (:func:`point_schedule`), and
:func:`analysis_cells` yields every schedule the static verifier holds
clean: the grid, 512 workers, composed two-level and three-axis meshes,
codec'd and model-bracketed cells — the same 157 cells, with the same
labels, as the reference.

Two profiles, both the reference's and both analytic models, not
measurements of any card: ``paper`` (P100-class compute, the paper's
links) and ``v5e`` (the reference's TPU target, ``core/hw.py``'s
``V5E``, its ICI link and gRPC transport).

Two execution backends, as in the reference:

``model``     the timeline cost model (any p).
``measured``  the host wall-clock of the design's reducer on spawned
              ranks (:func:`measure_design_latencies`): each distinct
              fused-bucket size (:func:`bucket_sizes`) is reduced by
              ``reducers.allreduce`` on a :class:`~repro_torch.core.dist.
              Group` of p ranks, the best of ``reps`` calls after one
              warm-up, each opened with a device sync and a barrier and
              closed with a device sync, the slowest rank's; every call's
              sum is checked exact.  The table is keyed by full-size
              bucket bytes and not rescaled (see
              :func:`measure_design_latencies`), and :func:`run_point`
              plays it through the same timeline, so measured and
              modelled rows share their keys.  ``compute_s`` stays the
              profile's analytic term, as in the reference.  Transport
              (``gloo``, ``cuda_ipc``) and device are the caller's and
              never swapped: the tests time gloo ranks on the host, the
              card both.  ``Horovod_NCCL2`` measures ``dist.psum``; ranks
              sharing one card cannot run NCCL (it refuses two ranks on
              one device), so there it is a gloo all-reduce staged
              through host memory on either transport.

The design → reducer mapping is DESIGN_STRATEGY (the PS transport maps
to the ``ps_gather`` pattern; both MPI designs execute ``rhd_rsa`` —
host staging is a cost-model term).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Sequence

from ..core import cost_model as cm
from ..core import hw
from ..core import overlap as ov
from ..core import schedule as schedule_mod
from ..models.cnn import PAPER_MODELS

# -- axes -------------------------------------------------------------------

DESIGNS = ("gRPC_PS", "Baidu_ring", "Horovod_NCCL2", "Horovod_MPI",
           "Horovod_MPI_Opt")
MODELS = tuple(PAPER_MODELS)
WORKERS = (1, 2, 4, 8, 16, 32, 64, 128)
BATCHES = (16, 32, 64)

BATCH_PER_DEV = 64            # paper's per-GPU sweet spot (Fig. 2)
FUSION_BYTES = 4 * 2 ** 20    # Horovod Tensor Fusion threshold (Sec. III-C2)

# Trainable-variable counts: how many gradient tensors each model hands
# the runtime per step.  ResNet-50's 161 is the paper's number (its PS
# pays one RPC per variable); MobileNet-v1 / NASNet-large are estimates
# from the layer structure (analytic only).
MODEL_VARIABLES = {"resnet50": 161, "mobilenet": 83, "nasnet-large": 930}

# What each design EXECUTES (measured backend / multidev checks): the
# gRPC PS is represented by its communication pattern;
# host staging (Horovod_MPI vs _Opt) is a cost-model-only term.
DESIGN_STRATEGY = {
    "gRPC_PS": "ps_gather",
    "Baidu_ring": "ring_rsa",
    "Horovod_NCCL2": "psum",
    "Horovod_MPI": "rhd_rsa",
    "Horovod_MPI_Opt": "rhd_rsa",
}


@dataclasses.dataclass(frozen=True)
class HwProfile:
    name: str
    flops: float
    mfu: float
    link: cm.LinkParams
    grpc: cm.LinkParams
    # per-step synchronous-distributed overhead sigma0*log2(p): stragglers
    # on a shared, randomly-placed dragonfly (Piz Daint, paper Sec. VI-D)
    # vs a dedicated, deterministic interconnect (~0).
    sync_s: float = 0.0
    # fixed per-step overhead (dispatch, optimizer, collective setup):
    # the term a larger per-device batch amortizes — the saturation
    # curve of the paper's Fig. 2.
    overhead_s: float = 450e-6


PROFILES = {
    "paper": HwProfile("paper", cm.PAPER_P100_FLOPS, 0.19,
                       cm.LinkParams(alpha_s=5e-6, bandwidth=3e9),
                       cm.LinkParams(50e-6, 3e9), sync_s=6e-3),
    "v5e": HwProfile("v5e", hw.V5E.peak_bf16_flops, 0.45, cm.ICI,
                     cm.GRPC),
}


@dataclasses.dataclass(frozen=True)
class ExperimentPoint:
    """One cell of the characterization grid."""
    design: str
    model: str
    p: int
    batch_per_dev: int = BATCH_PER_DEV

    def validate(self):
        if self.design not in DESIGNS:
            raise ValueError(f"design {self.design!r} not in {DESIGNS}")
        if self.model not in PAPER_MODELS:
            raise ValueError(f"model {self.model!r} not in {MODELS}")
        if self.p < 1 or self.batch_per_dev < 1:
            raise ValueError(f"p/batch must be >= 1: {self}")


def grid(designs: Sequence[str] = DESIGNS,
         models: Sequence[str] = MODELS,
         workers: Sequence[int] = WORKERS,
         batches: Sequence[int] = (BATCH_PER_DEV,)) -> list[ExperimentPoint]:
    """The declarative grid: the cross product of the four axes."""
    pts = [ExperimentPoint(d, m, p, b)
           for d in designs for m in models for p in workers
           for b in batches]
    for pt in pts:
        pt.validate()
    return pts


# -- per-design communication costs -----------------------------------------

def design_latency_fn(design: str, p: int,
                      prof: HwProfile) -> Callable[[float], float]:
    """Per-message allreduce latency for one fused bucket under each
    design: the PS transport pays one RPC per VARIABLE (no fusion — the
    paper's gRPC pain point), the Horovod-family designs reduce FUSED
    buckets."""
    if design == "gRPC_PS":
        return lambda b: cm.allreduce_latency(
            "ps_gather", b, p, link=prof.grpc, ps_shards=max(p // 8, 1))
    if design == "Baidu_ring":
        return lambda b: cm.allreduce_latency("ring_rsa", b, p,
                                              link=prof.link)
    if design == "Horovod_NCCL2":
        return lambda b: cm.allreduce_latency("psum", b, p, link=prof.link)
    if design == "Horovod_MPI":
        return lambda b: cm.allreduce_latency_host_staged(
            "rhd_rsa", b, p, link=prof.link)
    if design == "Horovod_MPI_Opt":
        return lambda b: cm.allreduce_latency("rhd_rsa", b, p,
                                              link=prof.link)
    raise ValueError(f"unknown design {design!r}; one of {DESIGNS}")


def fusion_threshold(design: str) -> int:
    """PS reduces one message per variable; allreduce designs fuse."""
    return 0 if design == "gRPC_PS" else FUSION_BYTES


def compute_seconds(model: str, prof: HwProfile,
                    batch_per_dev: int = BATCH_PER_DEV) -> float:
    """Per-device fwd+bwd compute time (3x forward FLOPs at the
    profile's MFU)."""
    info = PAPER_MODELS[model]
    return 3 * info["gflops"] * 1e9 * batch_per_dev \
        / (prof.flops * prof.mfu)


def point_schedule(model: str, p: int, design: str, prof: HwProfile,
                   latency_fn: Callable[[float], float] | None = None
                   ) -> schedule_mod.ReduceSchedule:
    """The design's resolved schedule for one grid cell, as a DETACHED
    ReduceSchedule IR (core/schedule.py): the same object the dryrun
    records for real configs, built here from the analytic model's
    variable list — one bucket per fused message, decomposed into
    stages of the design's executed strategy (DESIGN_STRATEGY).
    ``latency_fn`` overrides the per-bucket latency (the per-design
    cost functions, or the measured backend's wall-clock table); p=1
    yields an empty schedule (no communication)."""
    strategy = DESIGN_STRATEGY[design]
    if p == 1:
        return schedule_mod.synthetic([], strategy, (1,), ("data",),
                                      intra=prof.link)
    info = PAPER_MODELS[model]
    sizes = ov.fused_bucket_bytes(info["params"] * 4,
                                  MODEL_VARIABLES[model],
                                  fusion_threshold(design))
    if latency_fn is None:
        latency_fn = design_latency_fn(design, p, prof)
    return schedule_mod.synthetic(sizes, strategy, (p,), ("data",),
                                  intra=prof.link, latency_fn=latency_fn,
                                  threshold_bytes=fusion_threshold(design))


def step_timeline(model: str, p: int, design: str, prof: HwProfile,
                  batch_per_dev: int = BATCH_PER_DEV,
                  latency_fn: Callable[[float], float] | None = None
                  ) -> ov.Timeline:
    """Timeline-simulated step: every design overlaps communication
    with backward compute to the extent bucket readiness allows (the
    wait-free-backprop schedule of core/overlap.py), played from the
    cell's ReduceSchedule IR.  ``latency_fn`` overrides the cost model
    — the measured backend passes measured per-bucket latencies through
    the SAME composition."""
    compute_s = compute_seconds(model, prof, batch_per_dev)
    sched = point_schedule(model, p, design, prof, latency_fn=latency_fn)
    return ov.simulate_schedule(sched, compute_s)


def sync_seconds(p: int, prof: HwProfile) -> float:
    import math
    return prof.sync_s * math.log2(p) if p > 1 else 0.0


def step_time(model: str, p: int, design: str, prof: HwProfile,
              batch_per_dev: int = BATCH_PER_DEV) -> float:
    tl = step_timeline(model, p, design, prof, batch_per_dev)
    return tl.step_s + sync_seconds(p, prof) + prof.overhead_s


def throughput(model: str, p: int, design: str, prof: HwProfile,
               batch_per_dev: int = BATCH_PER_DEV) -> float:
    return p * batch_per_dev / step_time(model, p, design, prof,
                                         batch_per_dev)


# -- static-verification surface (repro_torch.analysis) ---------------------

# Beyond-grid meshes the static verifier covers: worker counts past the
# executable ceiling, composed two-level (pods × data) meshes including
# the 512-device production shape, and the three-axis multi-pod fold.
ANALYSIS_WORKERS = WORKERS + (512,)
ANALYSIS_COMPOSED_MESHES = ((2, 16), (4, 8), (2, 256), (3, 8))
ANALYSIS_FLAT3_MESH = (2, 16, 16)

# Codec'd schedules the static verifier must prove sound (SV008):
# every wire codec with a derivable bound, on flat and composed meshes,
# including the 512-chip production mesh only the static path reaches.
# (strategy, axis_sizes, axis_names, codec spec)
ANALYSIS_CODEC_CELLS = (
    ("ring_rsa", (8,), ("data",), "int8"),
    ("ring_rsa×rhd_rsa", (4, 8), ("pod", "data"), "int8×bf16"),
    ("rhd_rsa", (64,), ("data",), "fp8_e4m3"),
    ("ring_rsa×rhd_rsa", (2, 256), ("pod", "data"), "fp8_e4m3"),
)

# Model-bracketed three-level schedules (core/manual.py): the dp
# levels run on the 1/m bracket chunk and a terminal ``ag@model``
# reassembles — the per-bucket IR the full-manual train step executes
# on model-parallel meshes.  Includes the 2×16×16 production mesh the
# 512-device dryrun compiles for real (dp = pod×data, m = 16).
# (strategy, dp axis_sizes, dp axis_names, model_axis_size)
ANALYSIS_BRACKET_CELLS = (
    ("rhd_rsa", (16,), ("data",), 2),
    ("ring_rsa×rhd_rsa", (2, 2), ("pod", "data"), 2),
    ("ring_rsa×rhd_rsa", (2, 16), ("pod", "data"), 16),
)


def analysis_cells(designs: Sequence[str] = DESIGNS,
                   models: Sequence[str] = MODELS,
                   workers: Sequence[int] = ANALYSIS_WORKERS,
                   profile: str = "paper"):
    """Yield ``(label, ReduceSchedule)`` for every schedule the repo
    registers — the verification surface of ``python -m repro_torch.analysis
    --schedules``.  Covers the full characterization grid (every design
    × model × p, one resolved IR per cell via :func:`point_schedule`),
    plus the meshes only the *static* path can reach: 512 workers,
    composed two-level ``ring_rsa×<outer>`` schedules on multi-pod
    meshes (including 2×256 = the 512-chip production mesh), a
    three-axis flat fold, codec'd cells (SV008), and model-bracketed
    three-level cells (including 2×16 dp × m=16 = the 2×16×16
    production mesh).  Every cell must verify clean."""
    prof = PROFILES[profile]
    for d in designs:
        for m in models:
            for p in workers:
                yield (f"{d}/{m}/p{p}",
                       point_schedule(m, p, d, prof))
    info = PAPER_MODELS["resnet50"]
    sizes = ov.fused_bucket_bytes(info["params"] * 4,
                                  MODEL_VARIABLES["resnet50"],
                                  FUSION_BYTES)
    for pods, d in ANALYSIS_COMPOSED_MESHES:
        for outer in schedule_mod.OUTER_ALGORITHMS:
            strat = schedule_mod.composed_name("ring_rsa", outer)
            yield (f"composed/{strat}/{pods}x{d}",
                   schedule_mod.synthetic(sizes, strat, (pods, d),
                                          ("pod", "data"),
                                          intra=prof.link))
    for strat in ("rhd_rsa", "ring_rsa", "psum"):
        mesh = "x".join(str(s) for s in ANALYSIS_FLAT3_MESH)
        yield (f"flat3/{strat}/{mesh}",
               schedule_mod.synthetic(sizes, strat, ANALYSIS_FLAT3_MESH,
                                      ("pod", "data", "model"),
                                      intra=prof.link))
    for strat, mesh_sizes, names, codec in ANALYSIS_CODEC_CELLS:
        mesh = "x".join(str(s) for s in mesh_sizes)
        yield (f"codec/{strat}/{mesh}/{codec}",
               schedule_mod.synthetic(sizes, strat, mesh_sizes, names,
                                      intra=prof.link, codec=codec))
    for strat, mesh_sizes, names, m in ANALYSIS_BRACKET_CELLS:
        mesh = "x".join(str(s) for s in mesh_sizes)
        yield (f"bracket/{strat}/{mesh}xm{m}",
               schedule_mod.synthetic(sizes, strat, mesh_sizes, names,
                                      intra=prof.link,
                                      model_axis="model",
                                      model_axis_size=m))


# -- matrix execution -------------------------------------------------------

def _row(point: ExperimentPoint, prof: HwProfile, backend: str,
         tl: ov.Timeline,
         sched: "schedule_mod.ReduceSchedule | None" = None) -> dict:
    st = tl.step_s + sync_seconds(point.p, prof) + prof.overhead_s
    ips = point.p * point.batch_per_dev / st
    base = throughput(point.model, 1, "Horovod_MPI_Opt", prof,
                      point.batch_per_dev)
    row = {
        "design": point.design, "model": point.model, "p": point.p,
        "batch_per_dev": point.batch_per_dev,
        "profile": prof.name, "backend": backend,
        "step_s": st, "images_per_s": ips,
        "efficiency": ips / (base * point.p),
        "comm_s": tl.comm_s, "exposed_comm_s": tl.exposed_comm_s,
        "hidden_frac": tl.overlap_fraction,
        "n_buckets": len(tl.events),
        # the wire-codec spec the cell's schedule was resolved under
        # ("none" for the whole characterization grid today — the field
        # exists so codec'd rows are first-class, not a side channel)
        "codec": sched.codec if sched is not None else "none",
    }
    if sched is not None and sched.buckets:
        # the same repro/schedule/v1 record the dryrun writes, grouped
        # (synthetic buckets are mostly identical; per-bucket fidelity
        # would bloat the trajectory artifact for no information)
        row["schedule"] = sched.to_json(group=True)
    return row


def run_point(point: ExperimentPoint, profile: str = "paper",
              backend: str = "model",
              measured_latencies: Mapping[int, float] | None = None) -> dict:
    """Evaluate one grid cell.  ``backend="measured"`` needs the
    per-bucket-size measured latency table from
    :func:`measure_design_latencies` (seconds, keyed by message bytes).
    Both backends resolve the cell's ReduceSchedule IR and play it
    through the same timeline composition."""
    point.validate()
    prof = PROFILES[profile]
    if backend == "model":
        lat = None
    elif backend == "measured":
        if point.p > 1 and measured_latencies is None:
            raise ValueError("backend='measured' needs measured_latencies "
                             "(measure_design_latencies)")
        lat = None if point.p == 1 else \
            (lambda b: measured_latencies[int(b)])
    else:
        raise ValueError(f"unknown backend {backend!r}; model|measured")
    sched = point_schedule(point.model, point.p, point.design, prof,
                           latency_fn=lat)
    compute_s = compute_seconds(point.model, prof, point.batch_per_dev)
    tl = ov.simulate_schedule(sched, compute_s)
    return _row(point, prof, backend, tl, sched)


def run_matrix(points: Iterable[ExperimentPoint] | None = None,
               profile: str = "paper", backend: str = "model") -> list[dict]:
    """Evaluate the matrix on the cost-model backend (the measured
    backend goes point by point through :func:`run_point` with its
    latency tables: :func:`run_measured_point`,
    :func:`measure_points`)."""
    if points is None:
        points = grid()
    return [run_point(pt, profile=profile, backend=backend)
            for pt in points]


def query(rows: Iterable[Mapping], **filters) -> list[dict]:
    """Filter matrix rows by exact field match:
    ``query(rows, model="resnet50", p=64)``."""
    out = []
    for r in rows:
        if all(r.get(k) == v for k, v in filters.items()):
            out.append(dict(r))
    return out


def value(rows: Iterable[Mapping], field: str, **filters) -> float:
    """The single value of ``field`` selected by ``filters`` — raises if
    the query is not unique (a claim must pin ONE cell)."""
    hits = query(rows, **filters)
    if len(hits) != 1:
        raise ValueError(f"query {filters} matched {len(hits)} rows, "
                         "expected exactly 1")
    return hits[0][field]


# -- measured backend (spawned ranks) ---------------------------------------

def bucket_sizes(model: str, design: str) -> list[int]:
    """The distinct fused-message sizes the design's schedule reduces
    for ``model`` — what the measured backend has to wall-clock."""
    info = PAPER_MODELS[model]
    sizes = ov.fused_bucket_bytes(info["params"] * 4,
                                  MODEL_VARIABLES[model],
                                  fusion_threshold(design))
    return sorted({int(b) for b in sizes})


def _slot_bytes(strategy: str, p: int, n: int) -> int:
    """The receive slot a ``cuda_ipc`` group of ``p`` ranks needs for
    ``strategy``'s hops on ``n`` float32 elements (0: no hop)."""
    from ..core.plan_cache import stage_slot_bytes
    stages = schedule_mod.decompose(strategy, n * 4, ("data",), [p])
    return max((stage_slot_bytes(st, (n,), 4) for st in stages),
               default=0)


def group_latencies(design: str, group, sizes: Sequence[int],
                    reps: int = 5, scale: float = 1.0,
                    device=None) -> dict[int, float]:
    """Wall-clock the design's reducer (``DESIGN_STRATEGY``) through
    ``reducers.allreduce`` on ``group`` for each message size (bytes);
    every rank of the group calls it.  Returns ``{bytes: seconds}``:
    the best of ``reps`` calls after one warm-up, each opened with a
    device sync and a barrier and closed with a device sync, the
    slowest rank's, the same on every rank.  Rank r reduces a buffer of
    r + 1, so every call's sum, p(p+1)/2 everywhere, is exact and
    checked (``RuntimeError`` otherwise).  On a ``cuda_ipc`` group a
    channel of its own, sized to the largest hop, carries the payloads
    and is closed after.  ``scale`` as in
    :func:`measure_design_latencies`."""
    import math
    import time

    import torch

    from ..core import dist as dist_mod
    from ..core import reducers
    from ..kernels.backend import resolve_device
    from ..telemetry.closure import _barrier, _group_max, _sync

    device = resolve_device(device)
    strategy = DESIGN_STRATEGY[design]
    p = group.size
    elems = {int(b): max(max(int(b * scale), 4) // 4, 1) for b in sizes}
    channel = None
    if group.transport == "cuda_ipc" and p > 1:
        slot = max((_slot_bytes(strategy, p, n) for n in elems.values()),
                   default=0)
        if slot:
            channel = dist_mod.IpcChannel(group, slot, device)
            group = channel.group
    want = p * (p + 1) / 2
    out: dict[int, float] = {}
    try:
        for n_bytes, n in elems.items():
            x = torch.full((n,), float(group.rank + 1), dtype=torch.float32,
                           device=device)
            y = reducers.allreduce(x, [group], strategy)      # warm-up
            best = math.inf
            for _ in range(max(reps, 1)):
                _sync(device)
                _barrier(group)
                t0 = time.perf_counter()
                y = reducers.allreduce(x, [group], strategy)
                _sync(device)
                best = min(best, time.perf_counter() - t0)
                if not bool((y == want).all()):
                    raise RuntimeError(
                        f"{design} ({strategy}) on {p} ranks: the sum of "
                        f"{n_bytes} B is not {want} everywhere")
            out[n_bytes] = best
        _barrier(group)
    finally:
        if channel is not None:
            channel.close()
    return dict(zip(out, _group_max(list(out.values()), group)))


def _rank_latencies(rank, world, jobs, reps, scale, device):
    """One rank of :func:`measure_jobs`: each job on a group of the
    world's first p ranks (the ranks outside it skip the job)."""
    import torch
    import torch.distributed as tdist

    from ..core.dist import Group

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    # new_group is collective over the world, even for its non-members
    pgs = {p: None if p == world else tdist.new_group(list(range(p)))
           for p in sorted({job[2] for job in jobs})}
    out = {}
    for transport, design, p, sizes in jobs:
        if rank < p:
            group = Group(pgs[p], name="data", transport=transport)
            out[(transport, design, p)] = group_latencies(
                design, group, sizes, reps, scale, device)
    return out


def measure_jobs(jobs: Sequence[tuple], reps: int = 5, scale: float = 1.0,
                 *, device=None) -> dict:
    """Wall-clock many ``(transport, design, p, sizes)`` jobs in one
    spawn of max(p) ranks (:func:`group_latencies` on a group of the
    first p); returns ``{(transport, design, p): {bytes: seconds}}``.
    The world runs on ``cuda_ipc`` when a job asks for it (its groups
    can then take either transport), else on gloo."""
    import tempfile

    from ..core.dist import run_ranks
    from ..kernels.backend import resolve_device

    device = str(resolve_device(device))
    world = max(job[2] for job in jobs)
    backend = "cuda_ipc" if any(job[0] == "cuda_ipc" for job in jobs) \
        else "gloo"
    with tempfile.TemporaryDirectory() as rdv:
        results = run_ranks(_rank_latencies, world,
                            (list(jobs), reps, scale, device),
                            backend=backend, rendezvous_dir=rdv, threads=1,
                            timeout_s=1800)
    return results[0]


def measure_design_latencies(design: str, p: int, sizes: Sequence[int],
                             reps: int = 5, scale: float = 1.0, *,
                             transport: str, device=None) -> dict[int, float]:
    """Wall-clock the design's reducer on ``p`` spawned ranks of
    ``transport`` (``gloo`` or ``cuda_ipc``) on ``device`` (``None``:
    the card) for each message size (bytes); returns {bytes: seconds}.

    ``scale`` shrinks the MEASURED message so host-run checks stay fast
    on the ~100 MB ResNet-50 buckets; the returned latency is the
    honest wall-clock of the scaled message, keyed by the full-size
    bucket bytes (NOT rescaled back up — a linear rescale would inflate
    the fixed per-call dispatch/alpha term by 1/scale).  Scaled
    measurements therefore sit closer to the alpha-dominated regime:
    per-design comparisons at equal scale remain apples-to-apples, but
    absolute full-size latencies need scale=1."""
    return measure_jobs([(transport, design, p, list(sizes))], reps, scale,
                        device=device)[(transport, design, p)]


def run_measured_point(point: ExperimentPoint, profile: str = "paper",
                       reps: int = 5, scale: float = 1.0, *,
                       transport: str, device=None) -> dict:
    """One grid cell on the measured backend: wall-clock every distinct
    bucket size of the design's schedule, then compose the SAME timeline
    the model backend uses."""
    lats = None
    if point.p > 1:
        lats = measure_design_latencies(
            point.design, point.p, bucket_sizes(point.model, point.design),
            reps=reps, scale=scale, transport=transport, device=device)
    return run_point(point, profile=profile, backend="measured",
                     measured_latencies=lats)


def measure_points(points: Sequence[ExperimentPoint],
                   transports: Sequence[str], profile: str = "paper",
                   reps: int = 5, scale: float = 1.0, *,
                   device=None) -> list[tuple[str, dict]]:
    """:func:`run_measured_point` for every point on every transport,
    measured in one spawn of max(p) ranks: ``[(transport, row), ...]``
    in the order given (each design's distinct bucket sizes measured
    once per p, whatever the model asks for)."""
    want: dict = {}
    for pt in points:
        pt.validate()
        if pt.p > 1:
            for tr in transports:
                want.setdefault((tr, pt.design, pt.p), set()).update(
                    bucket_sizes(pt.model, pt.design))
    lats = measure_jobs([(tr, d, p, sorted(sizes))
                         for (tr, d, p), sizes in want.items()],
                        reps, scale, device=device) if want else {}
    return [(tr, run_point(pt, profile=profile, backend="measured",
                           measured_latencies=lats.get((tr, pt.design,
                                                        pt.p))))
            for tr in transports for pt in points]
