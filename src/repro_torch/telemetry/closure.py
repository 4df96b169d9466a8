"""Measured-vs-predicted timeline closure.

Counterpart of ``repro/telemetry/closure.py``, with its names, constants
and schema (``repro/telemetry/v1``).  The cost model predicts a latency
for every IR stage (``Stage.predicted_s``) and the overlap simulator
turns those into a timeline; the closure measures what each distinct
stage costs when it runs alone.  Where the reference replays a stage as
its own jitted collective on a submesh, the port replays it on a
process group of ``axis_size`` ranks (:func:`measure_stage`): one
warm-up call, then the best of ``reps`` host-timed calls, each opened
with a device sync and a barrier and closed with a device sync; the
slowest rank's time is the stage's, the same value on every rank.

Host seconds and the cost model's constants differ by orders of
magnitude, so residuals are read through a fitted scalar: ``k =
Σ(measured·predicted) / Σ(predicted²)`` (least squares through the
origin), one per participant count.  The per-stage ratio
``max(m/(k·p), (k·p)/m)`` must sit inside a declared two-sided band,
over stages whose wire bytes fall inside ``[MIN_BAND_BYTES,
MAX_BAND_BYTES]``; smaller stages are dominated by dispatch latency,
larger ones by the host's cache curvature.  Out-of-regime stages are
reported with their ratio but neither fitted nor gated.  The band was
declared for host-CPU replays.  On the card the replays are bound by
each hop's host time, flat in the message size, and miss it: the
canonical artifact is measured on the host's CPU, and the card's
``cuda_ipc`` run is kept beside it as a record (``artifacts_torch/``).

:func:`check_artifact` re-derives a committed artifact's predicted side
from the CURRENT cost model without re-measuring, so a cost-model change
that forgets a re-emit fails it.  It takes the artifact's path: the
reference's ``BENCH_telemetry.json`` passes it unchanged.

    python -m repro_torch.telemetry.closure --check PATH
    python -m repro_torch.telemetry.closure --emit PATH [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Sequence

import torch
import torch.distributed as tdist

from . import metrics as metrics_mod
from . import trace as trace_mod

TELEMETRY_SCHEMA = "repro/telemetry/v1"

# Two-sided residual band: measured within BAND_FACTOR× of k·predicted,
# both directions (the reference's constants).
BAND_FACTOR = 5.0

# Stages with fewer wire bytes than this are dominated by dispatch
# latency and are reported but neither fitted nor gated...
MIN_BAND_BYTES = 256 * 1024

# ... and stages with more sit above the host's cache knee, where
# effective bandwidth falls with buffer size.
MAX_BAND_BYTES = 64 * 1024 * 1024


# ---------------------------------------------------------------------------
# measured replay: one collective per distinct IR stage
# ---------------------------------------------------------------------------

def stage_key(st) -> tuple:
    """Dedup key: stages with the same (op, algorithm, axis size,
    payload, codec) replay identically, whatever bucket they sit in."""
    return (st.op, st.algorithm, int(st.axis_size), int(st.n_bytes),
            getattr(st, "codec", "none") or "none")


def _stage_callable(st, group):
    """The body replaying ONE stage alone on ``group``.  An
    ``all_gather`` cannot run through ``execute_stages`` without its
    scatter, so the ring reducers are driven directly; the local buffer
    carries ``st.n_bytes``, the stage's input payload on the busiest
    rank."""
    from ..core import reducers

    permute = reducers._stage_permute(st)
    if st.op == "reduce_scatter":
        return lambda x: reducers.ring_reduce_scatter(
            x, group, permute=permute)[0]
    if st.op == "all_gather":
        p = int(st.axis_size)
        return lambda x: reducers.ring_all_gather(
            x, group, x.shape[0] * p, permute=permute)
    return lambda x: reducers.execute_stages(x, [st], {st.axis: group})


def _sync(device: torch.device) -> None:
    """The host's wait for ``device``.  On the card the process's
    ``cuda_ipc`` channels sync first: their waits on the card have no
    timeout of their own, and a peer that never posts raises there,
    naming it."""
    if device.type == "cuda":
        from ..core import dist as dist_mod
        dist_mod.sync_channels()
        torch.cuda.synchronize(device)


def _barrier(group) -> None:
    if group.size > 1:
        tdist.barrier(group=group.pg)


def _group_max(values: Sequence[float], group) -> List[float]:
    """The largest of each value over ``group``'s ranks (every rank of
    the group calls it with its own)."""
    if group.size == 1 or not values:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64)
    if group.backend == "nccl":
        t = t.cuda()
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX, group=group.pg)
    return [float(v) for v in t.cpu()]


def _pattern(n: int, start: int, dtype, device) -> torch.Tensor:
    """Elements ``start .. start+n`` of the reference's replay input
    ``(arange % 13) - 6``, made on ``device``."""
    x = torch.arange(start, start + n, dtype=torch.float64,
                     device=device) % 13 - 6.0
    return x.to(dtype)


def measure_stage(st, group, wire_dtype: str = "float32", reps: int = 3,
                  device=None) -> float:
    """Best-of-``reps`` host seconds for one stage replayed on ``group``
    (``st.axis_size`` ranks, every one of which calls this), after one
    warm-up call; the slowest rank's, on every rank.  On a ``cuda_ipc``
    group the replay binds a channel of its own sized to the stage's
    largest hop, and closes it after."""
    from ..core import dist as dist_mod
    from ..core.plan_cache import stage_slot_bytes
    from ..core.schedule import DTYPES
    from ..kernels.backend import resolve_device

    device = resolve_device(device)
    p = int(st.axis_size)
    if group.size != p:
        raise ValueError(f"stage {st.op}@{st.axis} needs {p} ranks; its "
                         f"group has {group.size}")
    coded = (getattr(st, "codec", "none") or "none") != "none"
    dtype = torch.float32 if coded else DTYPES[wire_dtype]
    itemsize = torch.empty((), dtype=DTYPES[wire_dtype]).element_size()
    n = max(int(st.n_bytes) // itemsize, 1)
    x = _pattern(n, group.rank * n, dtype, device)
    channel = None
    if group.transport == "cuda_ipc" and p > 1:
        channel = dist_mod.IpcChannel(
            group, stage_slot_bytes(st, (n,), x.element_size()), device)
        group = channel.group
    try:
        fn = _stage_callable(st, group)
        fn(x)                                # warm-up
        best = float("inf")
        for _ in range(max(reps, 1)):
            _sync(device)
            _barrier(group)
            t0 = time.perf_counter()
            fn(x)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        _barrier(group)
    finally:
        if channel is not None:
            channel.close()
    return _group_max([best], group)[0]


def measure_schedule(sched, groups, reps: int = 3,
                     device=None) -> Dict[str, float]:
    """Replay every stage of ``sched`` (deduplicated by
    :func:`stage_key`) on ``groups`` (axis name to
    :class:`~repro_torch.core.dist.Group`, or ``None`` on a rank outside
    the group that replays that axis's stages, which skips them; every
    rank of the world calls this); returns ``{ir_path: measured_s}``
    covering ALL paths, duplicates sharing one measurement, each the
    largest over the world's ranks.  When the global tracer is enabled
    each distinct replay records a ``wall`` span named by its IR
    path."""
    wire = sched.wire_dtype
    tr = trace_mod.get_tracer()
    cache: Dict[tuple, float] = {}
    keys: Dict[str, tuple] = {}
    out: Dict[str, float] = {}
    for path, _bucket, st in sched.iter_stages():
        if st.op == "shard":
            # the model bracket's opener: a local slice, nothing on the
            # wire; recorded at zero so the report keeps every path
            out[path] = 0.0
            continue
        key = stage_key(st)
        keys[path] = key
        if key in cache:
            continue
        if groups[st.axis] is None:
            cache[key] = 0.0
            continue
        with tr.span(f"probe:{path}", cat="wall", ir_path=path,
                     op=st.op, algorithm=st.algorithm,
                     axis_size=int(st.axis_size),
                     n_bytes=int(st.n_bytes),
                     wire_bytes=int(st.wire_bytes),
                     codec=getattr(st, "codec", "none") or "none",
                     reps=reps) as sp:
            cache[key] = measure_stage(st, groups[st.axis], wire,
                                       reps=reps, device=device)
            sp.set("measured_s", cache[key])
        metrics_mod.REGISTRY.histogram(
            "probe_stage_s",
            help="measured-replay stage latency (s)").observe(
                cache[key], op=st.op, algorithm=st.algorithm)
    # Ranks of one axis measure different groups (each pod's data
    # group): the world's largest, so every rank reports one value.
    if tdist.is_available() and tdist.is_initialized():
        from ..core.dist import Group
        cache = dict(zip(cache, _group_max(list(cache.values()),
                                           Group(name="world"))))
    for path, key in keys.items():
        out[path] = cache[key]
    return {path: out[path] for path, _b, _s in sched.iter_stages()}


# ---------------------------------------------------------------------------
# fused-vs-unfused replay
# ---------------------------------------------------------------------------

def _rank_index(sched, groups) -> tuple:
    """(this rank's index over the flattened dp ranks, their count),
    ``pod · d + data`` as the batch is split."""
    index, size = 0, 1
    for ax in sched.axis_names:
        g = groups[ax]
        index, size = index * g.size + g.rank, size * g.size
    return index, size


def measure_fused_replay(sched, groups, reps: int = 3, device=None) -> dict:
    """Replay one ATTACHED schedule (``sched.plan`` set) through both
    execution routes, interleaved, and time them.

    Unfused: every ``fused_hop`` flag cleared, each bucket reduced on
    its own by a :class:`~repro_torch.core.plan_cache.StageExecutor`
    built for that schedule alone (plain torch hops).  Fused: every
    fusable flag set, the whole tree through the process-global
    executor cache (K1–K3 on a coded wire, K4 on ``ps_gather``).  Both
    start from the same leaves, made anew before each call outside the
    timed window: the reference's ``(arange % 13) - 6`` over the
    flattened dp ranks, this rank's slice.

    Returns the best host seconds of each route (the slowest rank's),
    the speedup, the fused route's residual against the unfused one
    (absmax-relative per bucket, the largest), and the executor cache's
    stats after the run."""
    from .. import tree as tree_mod
    from ..core import schedule as schedule_mod
    from ..core.plan_cache import GLOBAL_EXECUTOR_CACHE, StageExecutor
    from ..kernels.backend import resolve_device

    if sched.plan is None:
        raise ValueError("measure_fused_replay needs an attached schedule "
                         "(plan is None): the executor reduces the plan's "
                         "leaves")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        # the executor cache keys on the device as the step's tensors
        # name it
        device = torch.device("cuda", torch.cuda.current_device())
    plan = sched.plan
    index, p = _rank_index(sched, groups)
    metas = plan.leaves

    def fresh():
        leaves = []
        for m in metas:
            n = max(math.prod(m.shape), 1)
            leaves.append(_pattern(n, index * n, m.dtype, device)
                          .reshape(m.shape))
        return leaves

    fused = schedule_mod.with_fused_hops(sched, True)
    unfused = schedule_mod.with_fused_hops(sched, False)
    ex = GLOBAL_EXECUTOR_CACHE.executor_for(fused, groups, device)
    plain = StageExecutor(unfused, groups, device)
    world = None
    if tdist.is_available() and tdist.is_initialized():
        from ..core.dist import Group
        world = Group(name="world")

    def run_unfused(leaves):
        return [plain.reduce_bucket(
            i, [leaves[j] for j in plan.buckets[b.index].leaf_indices])[0]
            for i, b in enumerate(unfused.buckets)]

    def run_fused(leaves):
        return tree_mod.leaves(ex(leaves))   # a list is a tree of leaves

    def timed(run):
        leaves = fresh()
        _sync(device)
        if world is not None:
            _barrier(world)
        t0 = time.perf_counter()
        out = run(leaves)
        _sync(device)
        return time.perf_counter() - t0, out

    try:
        _, ref = timed(run_unfused)          # warm-up, and the reference
        _, got = timed(run_fused)
        best_u = best_f = float("inf")
        for _ in range(max(reps, 1)):
            best_u = min(best_u, timed(run_unfused)[0])
            best_f = min(best_f, timed(run_fused)[0])
        if world is not None:
            _barrier(world)
    finally:
        plain.close()
    if world is not None:
        best_u, best_f = _group_max([best_u, best_f], world)

    max_ratio = 0.0
    for i, b in enumerate(sched.buckets):
        r = ref[i].detach().to(torch.float64).reshape(-1)
        g = torch.cat([got[j].detach().to(torch.float64).reshape(-1)
                       for j in plan.buckets[b.index].leaf_indices])
        absmax = float(r.abs().max()) if r.numel() else 0.0
        diff = float((g[:r.numel()] - r).abs().max()) if r.numel() else 0.0
        if absmax > 0:
            max_ratio = max(max_ratio, diff / absmax)
        elif diff > 0:
            max_ratio = float("inf")
    metrics_mod.record_executor_cache(GLOBAL_EXECUTOR_CACHE)
    return {
        "unfused_s": best_u,
        "fused_s": best_f,
        "speedup": (best_u / best_f) if best_f > 0 else float("inf"),
        "residual_rel": max_ratio,
        "executor_traces": ex.traces,
        "executor_stats": GLOBAL_EXECUTOR_CACHE.stats(),
    }


# ---------------------------------------------------------------------------
# calibration + residual table
# ---------------------------------------------------------------------------

def calibrate(pairs: Sequence[tuple]) -> float:
    """Least-squares-through-origin scale k for measured ≈ k·predicted
    over ``(predicted_s, measured_s)`` pairs."""
    num = sum(m * p for p, m in pairs)
    den = sum(p * p for p, _ in pairs)
    return num / den if den > 0 else 0.0


def closure_report(sched, measured: Dict[str, float]) -> dict:
    """Per-stage residual table + band verdict for one schedule.

    ``measured`` maps IR paths (``bucket[i].stage[j]``) to host seconds,
    as :func:`measure_schedule` returns them.  Calibration is fitted per
    participant count (one k per distinct ``axis_size``, over that
    group's gated rows): replays of different participant counts have
    different effective bandwidths, which the cost model does not
    encode, while within one count the model's SIZE scaling must hold to
    the band.  ``calibration.k`` is the global fit over all gated rows,
    which :func:`measured_timeline` uses."""
    rows: List[dict] = []
    for path, _bucket, st in sched.iter_stages():
        if path not in measured:
            raise KeyError(f"no measurement for stage {path}")
        rows.append({
            "path": path, "op": st.op, "algorithm": st.algorithm,
            "axis": st.axis, "axis_size": int(st.axis_size),
            "n_bytes": int(st.n_bytes), "wire_bytes": int(st.wire_bytes),
            "codec": getattr(st, "codec", "none") or "none",
            "predicted_s": float(st.predicted_s),
            "measured_s": float(measured[path]),
            "gated": (MIN_BAND_BYTES <= int(st.wire_bytes)
                      <= MAX_BAND_BYTES),
        })
    fit = [r for r in rows if r["gated"]] or rows
    k = calibrate([(r["predicted_s"], r["measured_s"]) for r in fit])
    by_p: Dict[int, List[dict]] = {}
    for r in fit:
        by_p.setdefault(r["axis_size"], []).append(r)
    k_p = {p: calibrate([(r["predicted_s"], r["measured_s"])
                         for r in grp])
           for p, grp in by_p.items()}
    for r in rows:
        cal = k_p.get(r["axis_size"], k) * r["predicted_s"]
        r["calibrated_s"] = cal
        if cal > 0 and r["measured_s"] > 0:
            r["ratio"] = max(r["measured_s"] / cal, cal / r["measured_s"])
        else:
            r["ratio"] = float("inf")
    gated = [r for r in rows if r["gated"]]
    return {
        "band": {"factor": BAND_FACTOR, "min_bytes": MIN_BAND_BYTES,
                 "max_bytes": MAX_BAND_BYTES},
        "calibration": {
            "k": k, "n_fit": len(fit),
            "per_axis_size": {str(p): {"k": k_p[p],
                                       "n_fit": len(by_p[p])}
                              for p in sorted(by_p)},
        },
        "stages": rows,
        "n_stages": len(rows),
        "n_gated": len(gated),
        "max_ratio": max((r["ratio"] for r in gated), default=0.0),
        "all_within_band": all(r["ratio"] <= BAND_FACTOR for r in gated),
    }


def measured_timeline(sched, measured: Dict[str, float], k: float,
                      compute_s: float):
    """The overlap simulator replayed with MEASURED per-bucket latencies:
    each bucket's communication time is the sum of its stages' measured
    seconds mapped into model units through 1/k; readiness and the
    serialized channel are unchanged.  Its ``overlap_fraction`` against
    the predicted timeline's is the closure's end-to-end number."""
    from ..core import overlap

    if k <= 0:
        raise ValueError(f"non-positive calibration k={k}")
    by_bucket: Dict[int, float] = {}
    for path, bucket, _st in sched.iter_stages():
        by_bucket[bucket.index] = \
            by_bucket.get(bucket.index, 0.0) + measured[path] / k
    backward_s = compute_s * overlap.BACKWARD_FRACTION
    tasks = [dataclasses.replace(t, comm_s=by_bucket[t.index])
             for t in overlap.schedule_tasks(sched, backward_s)]
    return overlap.simulate(
        tasks, backward_s,
        serial_s=compute_s * (1.0 - overlap.BACKWARD_FRACTION))


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------

ARTIFACT_DEVICES = 8
ARTIFACT_REPS = 5
ARTIFACT_BYTES = (1 << 20, 4 << 20, 16 << 20)


def artifact_cells() -> List[dict]:
    """The canonical cell set: both ppermute algorithms flat at p=8, an
    int8-coded wire, and a composed two-level schedule on a (2,4)
    pod×data mesh — every stage ``op`` and the codec path appear."""
    from ..core import schedule as schedule_mod

    composed = f"ring_rsa{schedule_mod.SEP}rhd_rsa"
    cells = [
        {"name": "ring_rsa@8", "strategy": "ring_rsa", "codec": "none",
         "axis_names": ["data"], "axis_sizes": [8]},
        {"name": "rhd_rsa@8", "strategy": "rhd_rsa", "codec": "none",
         "axis_names": ["data"], "axis_sizes": [8]},
        {"name": "ring_rsa+int8@8", "strategy": "ring_rsa",
         "codec": "int8", "axis_names": ["data"], "axis_sizes": [8]},
        {"name": "ring×rhd@2x4", "strategy": composed, "codec": "none",
         "axis_names": ["pod", "data"], "axis_sizes": [2, 4]},
    ]
    for c in cells:
        c["bucket_bytes"] = list(ARTIFACT_BYTES)
        c["wire_dtype"] = "float32"
    return cells


def cell_schedule(cell: dict):
    """Rebuild a cell's DETACHED schedule from its recorded config — the
    same call at emit and at check time, so the predicted side is always
    the CURRENT cost model's."""
    from ..core import schedule as schedule_mod

    return schedule_mod.synthetic(
        cell["bucket_bytes"], cell["strategy"],
        axis_sizes=tuple(cell["axis_sizes"]),
        axis_names=tuple(cell["axis_names"]),
        wire_dtype=cell["wire_dtype"], codec=cell["codec"])


def _cell_groups(cell: dict) -> dict:
    """The cell's axes as process groups of the world (collective)."""
    from ..core.dist import Group
    from ..launch.mesh import make_groups

    if len(cell["axis_sizes"]) == 1:
        return {cell["axis_names"][0]: Group(name=cell["axis_names"][0])}
    return make_groups(*cell["axis_sizes"])


def _measure_cells_rank(rank, world, reps, device):
    """One rank of :func:`emit_artifact`: every cell, measured."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    out = {}
    for cell in artifact_cells():
        out[cell["name"]] = measure_schedule(
            cell_schedule(cell), _cell_groups(cell), reps=reps,
            device=device)
    return out


def build_artifact(measured_by_cell: Dict[str, Dict[str, float]],
                   platform: str, reps: int = ARTIFACT_REPS) -> dict:
    cells_out = []
    for cell in artifact_cells():
        sched = cell_schedule(cell)
        report = closure_report(sched, measured_by_cell[cell["name"]])
        cells_out.append({**cell, **report})
    return {
        "schema": TELEMETRY_SCHEMA,
        "generated_by": "python -m repro_torch.telemetry.closure --emit",
        "platform": platform,
        "devices": ARTIFACT_DEVICES,
        "reps": reps,
        "band": {"factor": BAND_FACTOR, "min_bytes": MIN_BAND_BYTES,
                 "max_bytes": MAX_BAND_BYTES},
        "cells": cells_out,
        "all_within_band": all(c["all_within_band"] for c in cells_out),
    }


def _where(device: str) -> str:
    """The card as ``nvidia-smi`` names it, with its power limit (a card
    may be capped below its maximum), or the host's CPU."""
    if not device.startswith("cuda"):
        model = "model unknown"
        try:
            with open("/proc/cpuinfo") as f:
                model = next(line.split(":", 1)[1].strip() for line in f
                             if line.startswith("model name"))
        except (OSError, StopIteration):
            pass
        import platform
        return (f"the host's CPU ({platform.machine()}, {model}, "
                f"{os.cpu_count()} cores)")
    import subprocess
    try:
        return "one " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"one {torch.cuda.get_device_name(0)} (power limit not read)"


def emit_artifact(path: str, reps: int = ARTIFACT_REPS, device=None) -> dict:
    """Measure the canonical cells on ``ARTIFACT_DEVICES`` spawned ranks
    and write the artifact to ``path``.  ``device``: ``None`` is the
    card (``cuda_ipc`` ranks), ``"cpu"`` the host (gloo ranks); the
    artifact's ``platform`` names the transport and where it ran (the
    card with its power limit, or the host's CPU)."""
    from ..core.dist import run_ranks
    from ..kernels.backend import resolve_device

    device = str(resolve_device(device))
    backend = "cuda_ipc" if device.startswith("cuda") else "gloo"
    with tempfile.TemporaryDirectory() as rdv:
        results = run_ranks(_measure_cells_rank, ARTIFACT_DEVICES,
                            (reps, device), backend=backend,
                            rendezvous_dir=rdv, threads=1, timeout_s=1800)
    artifact = build_artifact(
        results[0], f"{ARTIFACT_DEVICES} {backend} ranks on "
                    f"{_where(device)}", reps)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
        f.write("\n")
    return artifact


def check_artifact(path: str) -> List[str]:
    """Currency problems with a closure artifact at ``path``.

    Does NOT re-measure: it reloads the stored measured side, rebuilds
    the predicted side from the CURRENT cost model via
    :func:`cell_schedule`, and re-derives calibration and band verdicts,
    so a cost-model / decomposition / codec-accounting change trips it
    until the artifact is re-emitted."""
    problems: List[str] = []
    name = os.path.basename(path)
    if not os.path.exists(path):
        return [f"{name} missing — run python -m "
                f"repro_torch.telemetry.closure --emit {path}"]
    try:
        with open(path) as f:
            art = json.load(f)
    except ValueError as e:
        return [f"{name}: unparseable JSON ({e})"]
    if art.get("schema") != TELEMETRY_SCHEMA:
        return [f"{name}: schema {art.get('schema')!r} != "
                f"{TELEMETRY_SCHEMA}"]
    cells = art.get("cells", [])
    expected = {c["name"] for c in artifact_cells()}
    got = {c.get("name") for c in cells}
    if got != expected:
        problems.append(f"{name}: cell set {sorted(got)} != canonical "
                        f"{sorted(expected)} — re-emit")
        return problems
    if not any(c.get("codec", "none") != "none" for c in cells):
        problems.append(f"{name}: no codec'd cell")
    band = art.get("band", {})
    if band.get("factor") != BAND_FACTOR \
            or band.get("min_bytes") != MIN_BAND_BYTES \
            or band.get("max_bytes") != MAX_BAND_BYTES:
        problems.append(f"{name}: declared band {band} != current "
                        f"({BAND_FACTOR}, {MIN_BAND_BYTES}, "
                        f"{MAX_BAND_BYTES})")
    for cell in cells:
        sched = cell_schedule(cell)
        stored = {r["path"]: r for r in cell.get("stages", [])}
        fresh_paths = [p for p, _b, _s in sched.iter_stages()]
        if sorted(stored) != sorted(fresh_paths):
            problems.append(
                f"{name}: cell {cell['name']} stage paths drifted "
                f"(decomposition changed) — re-emit")
            continue
        measured = {}
        for p, _b, st in sched.iter_stages():
            row = stored[p]
            measured[p] = row["measured_s"]
            for field, current in (("predicted_s", float(st.predicted_s)),
                                   ("wire_bytes", int(st.wire_bytes))):
                ref = row.get(field)
                tol = 1e-9 * max(abs(current), 1e-30)
                if ref is None or abs(ref - current) > tol:
                    problems.append(
                        f"{name}: cell {cell['name']} {p}.{field} "
                        f"stored {ref} != current model {current} "
                        f"(cost model drifted) — re-emit")
        fresh = closure_report(sched, measured)
        if not fresh["all_within_band"]:
            bad = [r["path"] for r in fresh["stages"]
                   if r["gated"] and r["ratio"] > BAND_FACTOR]
            problems.append(
                f"{name}: cell {cell['name']} residuals out of band "
                f"against the current cost model: {bad}")
        if cell.get("all_within_band") is not True:
            problems.append(f"{name}: cell {cell['name']} committed "
                            f"with all_within_band != true")
    if art.get("all_within_band") is not True:
        problems.append(f"{name}: all_within_band != true")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="measured-vs-predicted timeline closure artifact")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--emit", metavar="PATH",
                      help=f"measure the canonical cells on "
                           f"{ARTIFACT_DEVICES} spawned ranks and write "
                           f"the artifact")
    mode.add_argument("--check", metavar="PATH",
                      help="validate an artifact against the current "
                           "cost model (no re-measure)")
    ap.add_argument("--reps", type=int, default=ARTIFACT_REPS)
    ap.add_argument("--device", default=None,
                    help="cpu (gloo ranks), or the card (the default; "
                         "cuda_ipc ranks)")
    args = ap.parse_args(argv)
    if args.emit:
        art = emit_artifact(args.emit, reps=args.reps, device=args.device)
        print(f"wrote {args.emit}: {len(art['cells'])} cells, "
              f"all_within_band={art['all_within_band']}")
        return 0 if art["all_within_band"] else 1
    problems = check_artifact(args.check)
    for p in problems:
        print(f"PROBLEM: {p}")
    if not problems:
        print(f"{os.path.basename(args.check)} current")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
