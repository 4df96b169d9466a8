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

The profile is the reference's ``paper`` one (P100-class compute, the
paper's links), an analytic model, not a measurement of any card.  The
reference's ``v5e`` profile and its measured backend
(``measure_design_latencies``, ``run_measured_point``, ``bucket_sizes``),
which wall-clocks the reducers on host devices, are not ported
(ROADMAP, Queue 1).

The design → reducer mapping is DESIGN_STRATEGY (the PS transport maps
to the ``ps_gather`` pattern; both MPI designs execute ``rhd_rsa`` —
host staging is a cost-model term).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Sequence

from ..core import cost_model as cm
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
    ``latency_fn`` overrides the per-bucket latency (default: the
    design's cost function); p=1 yields an empty schedule (no
    communication)."""
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
                  batch_per_dev: int = BATCH_PER_DEV) -> ov.Timeline:
    """Timeline-simulated step: every design overlaps communication
    with backward compute to the extent bucket readiness allows (the
    wait-free-backprop schedule of core/overlap.py), played from the
    cell's ReduceSchedule IR."""
    compute_s = compute_seconds(model, prof, batch_per_dev)
    sched = point_schedule(model, p, design, prof)
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


def run_point(point: ExperimentPoint, profile: str = "paper") -> dict:
    """Evaluate one grid cell on the analytic backend: resolve the
    cell's ReduceSchedule IR and play it through the timeline."""
    point.validate()
    prof = PROFILES[profile]
    sched = point_schedule(point.model, point.p, point.design, prof)
    compute_s = compute_seconds(point.model, prof, point.batch_per_dev)
    tl = ov.simulate_schedule(sched, compute_s)
    return _row(point, prof, "model", tl, sched)


def run_matrix(points: Iterable[ExperimentPoint] | None = None,
               profile: str = "paper") -> list[dict]:
    """Evaluate the matrix on the analytic backend."""
    if points is None:
        points = grid()
    return [run_point(pt, profile=profile) for pt in points]


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
