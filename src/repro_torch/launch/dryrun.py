"""Dry run: prove a distribution config coherent before renting the cards.

Counterpart of ``repro/launch/dryrun.py``.  For one (arch × input shape
× mesh) this module, without touching a device (everything is a meta
tensor, so nothing can fall back and no ``--device`` is taken):

1. builds the model on ``meta`` at full size;
2. for a training shape, resolves the plan the train step would execute
   at the mesh's dp axis sizes (``GradientAggregator.resolve``; on the
   model axis the shard-shaped gradients of ``core/manual.py``), runs
   the static verifier over it (``repro_torch.analysis.verify``) and
   records it under ``schedule`` (the reference's fields; ``ir`` is the
   grouped ``repro/schedule/v1`` record) with ``analysis`` and
   ``verified_static``;
3. estimates one rank's memory: the exact part (the parameter shards,
   their gradients and AdamW moments, and the inputs; or the parameters
   and the KV or state cache for serving), the full parameters the
   model axis gathers, and the activations autograd saves (counted on
   meta, ``launch/roofline.py``); and whether the total fits the card;
4. prices the step on the card (``launch/roofline.py``, H100 SXM):
   flops and aten bytes counted on meta at one rank's rows, the
   collective bytes from the resolved IR (or the serving step's
   all-gathers) over NVLink;
5. writes a JSON record with the reference's keys, which
   ``launch/report.py`` renders.

Meshes: ``16x16`` (data × model) and ``2x16x16`` (pod × data × model).
``status`` is ``OK`` (resolved, verified, priced and estimated), ``SKIP``
with the reference's reason (``long_500k`` on pure full attention), or
``FAIL`` with the error (``--seq-parallel``, which the port does not
implement, fails here as it would in the step).  The reference refuses
partial-auto meshes above 32 devices on old jax and records them as
statically verified ``SKIP`` s; the port has no such ceiling, so those
records are ``OK`` here.  Not ported: ``--legacy-partial-auto`` (jax's
partial-auto lowering; the port has only the full-manual step).

``--trace PATH`` (one record; the reference's ``_attach_trace``) turns
telemetry on and replays the train record's schedule, resolved as
above, through the closure's probe (``telemetry/closure.py``) on as many
spawned ranks as its largest axis (16 on both meshes), each stage on a
group of its own axis size: ``cuda_ipc`` ranks sharing the card, or
gloo ranks with ``--device cpu``.  It attaches the residual table as
``measured``, the measured overlap beside the predicted one as
``schedule.measured_overlap``, the metrics snapshot as ``metrics``, the
replay's ranks and memory (estimate and each rank's peak) as
``trace_replay``, and writes the Perfetto trace to PATH.  The replay's
memory is checked first: where the largest stage's buffers and channel
slots cannot fit 16 ranks of one card, ``measured`` records the error
and what to cut.

Two fields are not the card's: ``schedule.predicted_comm_s`` and the
timeline under ``schedule.overlap`` come from the cost model, whose
constants are the reference's (``core/cost_model.py``); the roofline's
``collective_s`` is the NVLink charge.  ``memory`` holds one rank's
estimate under the reference's ``memory_analysis`` keys
(``argument_size_in_bytes`` the exact part, ``temp_size_in_bytes`` the
activations and gathered parameters), ``memory_estimate`` its parts.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k \\
      [--multi-pod] [--strategy rhd_rsa] [--json out.json] \\
      [--trace trace.json [--device cpu]]
  python -m repro_torch.launch.dryrun --all [--multi-pod]   # in-process
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch

from .. import tree as tree_mod
from ..core import hw

MESHES = {False: ("16x16", ("data", "model"), (16, 16)),
          True: ("2x16x16", ("pod", "data", "model"), (2, 16, 16))}


def mesh_axes(multi_pod: bool) -> dict:
    """``{axis: size}`` of the production mesh."""
    _, names, sizes = MESHES[multi_pod]
    return dict(zip(names, sizes))


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_mod.leaves(tree)
               if isinstance(t, torch.Tensor))


def rows_per_rank(kind: str, global_batch: int, dp: int) -> int:
    """One rank's rows: the batch split over the dp ranks (training
    requires it to divide); serving runs every row on every rank when
    the dp size does not divide the batch (``serve/step.py``)."""
    if kind == "train":
        if global_batch % dp:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {dp} dp ranks")
        return global_batch // dp
    return global_batch // dp if global_batch % dp == 0 else global_batch


def param_shards(params, m: int):
    """``(shard-shaped meta params, model-axis specs)`` of one rank on a
    model axis of ``m`` (``core/manual.py``)."""
    from ..core import manual as manual_mod
    mspecs = manual_mod.model_shard_specs(params, m)
    return manual_mod.shard_param_structs(params, mspecs, m), mspecs


def memory_estimate(spec, kind: str, rows: int, seq: int, m: int = 1,
                    counts=None, params=None) -> dict:
    """One rank's memory for a step of ``kind`` at ``rows`` rows and
    sequence (or cache length) ``seq`` on a model axis of ``m``.

    ``exact`` — arithmetic on the meta tree, no estimate in it: the
    parameter shards; for training their gradients, the AdamW moments
    (two per parameter, the parameter's dtype) and the inputs; for
    serving the KV or state cache and the tokens.  ``gathered`` — the
    full parameters the model axis's gather boundary rebuilds (zero
    without one).  ``activations`` — the bytes autograd saves for
    backward (``counts.saved_bytes``, training only)."""
    from ..launch import roofline as rl
    from ..models import build_model
    model = build_model(spec)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0), "meta").tree()
    shards, _ = param_shards(params, m)
    p_bytes = _bytes(shards)
    full_bytes = _bytes(params)
    inputs = rl._inputs(spec, kind, rows, seq)
    exact = {"params": p_bytes, "inputs": _bytes(inputs)}
    if kind == "train":
        exact["grads"] = p_bytes
        exact["optimizer"] = 2 * p_bytes
    else:
        exact["cache"] = _bytes(model.init_cache(
            rows, rl.cache_len(spec, kind, seq), device="meta"))
    if counts is None:
        counts = rl.count_step(spec, kind, rows, seq)
    gathered = full_bytes - p_bytes if m > 1 else 0
    activations = int(counts.saved_bytes) if kind == "train" else 0
    exact_total = sum(exact.values())
    total = exact_total + gathered + activations + int(counts.output_bytes)
    return {"exact": exact, "exact_bytes": exact_total,
            "gathered_params_bytes": gathered,
            "activations_bytes": activations,
            "output_bytes": int(counts.output_bytes),
            "total_bytes": total, "card_bytes": hw.H100_SXM.hbm_bytes,
            "fits": total <= hw.H100_SXM.hbm_bytes}


def _aggregator(strategy, fusion_mb, sharding_aware, wire_dtype,
                selector_mode, selector_table, overlap, codec,
                error_feedback, dp_axes, model_axis):
    from ..core import AggregatorConfig, GradientAggregator
    from ..core.dist import Group
    axes = tuple(dp_axes) + ((model_axis,) if model_axis else ())
    return GradientAggregator(
        AggregatorConfig(strategy=strategy, fusion_threshold_mb=fusion_mb,
                         sharding_aware=sharding_aware,
                         wire_dtype=wire_dtype,
                         selector_mode=selector_mode,
                         selector_table=selector_table, overlap=overlap,
                         codec=codec or "none",
                         error_feedback=error_feedback),
        dp_axes, {ax: Group(name=ax) for ax in axes},
        model_axis=model_axis)


def resolve_schedule(agg, params, axis_sizes, m: int):
    """The train step's plan on the mesh: shard-shaped gradients on a
    model axis of ``m`` > 1."""
    from ..models import param_groups
    struct = param_shards(params, m)[0] if m > 1 else params
    return agg.resolve(struct, axis_sizes, groups=param_groups(struct),
                       model_axis_size=m if agg.model_axis else None)


def train_schedule(params, axes: dict, strategy: str = "rhd_rsa",
                   fusion_mb: float = 4.0, sharding_aware: bool = True,
                   wire_dtype: str = "", selector_mode: str = "analytic",
                   selector_table: str = "", overlap: bool = False,
                   codec: str = "", error_feedback: bool = False):
    """The plan the train step executes for ``params`` (meta, full
    size) on a mesh ``{axis: size}``: the aggregator over its dp axes,
    bracketed by the model axis when it is larger than 1."""
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    axis_sizes = tuple(int(axes[a]) for a in dp_axes)
    m = int(axes.get("model", 1))
    agg = _aggregator(strategy, fusion_mb, sharding_aware, wire_dtype,
                      selector_mode, selector_table, overlap, codec,
                      error_feedback, dp_axes, "model" if m > 1 else None)
    return resolve_schedule(agg, params, axis_sizes, m)


def _schedule_record(sched, roof, verify_diags) -> dict:
    """The reference's ``_schedule_record`` fields on the resolved IR.
    ``wire_check`` is None: nothing ran, so no bytes were sent to hold
    the IR against (the hop lint does that on a run,
    ``analysis/hop_lint.py``)."""
    from ..core import overlap as overlap_mod
    from ..launch import roofline as rl
    timeline = overlap_mod.simulate_schedule(sched,
                                             compute_s=roof.compute_s)
    return {
        "axis_sizes": list(sched.axis_sizes),
        "verify": {
            "n_errors": sum(d.severity == "error" for d in verify_diags),
            "n_warnings": sum(d.severity == "warn"
                              for d in verify_diags),
            "diagnostics": [d.to_json() for d in verify_diags],
        },
        "n_buckets": sched.n_buckets,
        "algorithms": sched.algorithms(),
        "decomposition": sched.render(),
        "predicted_comm_s": sched.predicted_s,
        "charged_comm_s": roof.collective_s,
        "wire_check": None,
        "overlap": rl.overlap_report(roof, timeline),
        "ir": sched.to_json(group=True),
    }


def _collectives(kinds: dict) -> dict:
    """The reference's ``collectives`` record from ``{kind: (count,
    bytes)}``."""
    return {"counts": {k: c for k, (c, _) in sorted(kinds.items())},
            "bytes_by_kind": {k: b for k, (_, b) in sorted(kinds.items())},
            "total_bytes": sum(b for _, b in kinds.values())}


def _ir_collectives(sched) -> dict:
    kinds: dict = {}
    for _p, _b, st in sched.iter_stages():
        if st.hlo_kind is None:
            continue
        c, n = kinds.get(st.hlo_kind, (0, 0))
        kinds[st.hlo_kind] = (c + 1, n + st.hlo_bytes)
    return kinds


def _serve_collectives(params, m: int, dp: int, counts) -> dict:
    """What one serving step sends from a rank: on a model axis each
    sharded leaf's shard to the m-1 other model ranks (the gather
    boundary), and the step's logits to the dp-1 other dp ranks."""
    from ..core import manual as manual_mod
    kinds: dict = {}
    if m > 1:
        shards, mspecs = param_shards(params, m)
        sharded = [(x, s) for x, s in zip(tree_mod.leaves(shards),
                                          tree_mod.leaves(mspecs))
                   if manual_mod.sharded_dim(s) is not None]
        kinds["all-gather"] = (
            len(sharded),
            (m - 1) * sum(x.numel() * x.element_size() for x, _ in sharded))
    if dp > 1:
        c, n = kinds.get("all-gather", (0, 0))
        kinds["all-gather"] = (c + 1, n + (dp - 1)
                               * int(counts.output_bytes))
    return kinds


def plan_step(spec, shape, axes: dict, strategy: str = "rhd_rsa",
              fusion_mb: float = 4.0, sharding_aware: bool = True,
              wire_dtype: str = "", selector_mode: str = "analytic",
              selector_table: str = "", overlap: bool = False,
              codec: str = "", error_feedback: bool = False,
              context: str = "") -> dict:
    """Resolve, verify, price and estimate one step of ``spec`` at
    ``shape`` (a ``configs.base.InputShape``) on a mesh ``{axis: size}``
    (dp axes ``pod``/``data``, and ``model``).  Returns the record's
    fields (``n_params``, ``cost``, ``memory``, ``memory_estimate``,
    ``collectives``, ``roofline``, and for training ``schedule``,
    ``analysis``, ``verified_static``)."""
    from ..analysis import verify as analysis_verify
    from ..launch import roofline as rl
    from ..models import build_model
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    axis_sizes = tuple(int(axes[a]) for a in dp_axes)
    m = int(axes.get("model", 1))
    dp = 1
    for s in axis_sizes:
        dp *= s
    chips = dp * m
    model = build_model(spec)
    params = model.init(torch.Generator().manual_seed(0), "meta").tree()
    n_params = sum(p.numel() for p in tree_mod.leaves(params))
    rows = rows_per_rank(shape.kind, shape.global_batch, dp)
    t0 = time.perf_counter()
    counts = rl.count_step(spec, shape.kind, rows, shape.seq_len)
    count_s = time.perf_counter() - t0
    mem = memory_estimate(spec, shape.kind, rows, shape.seq_len, m,
                          counts=counts, params=params)
    out = {"n_params": n_params, "rows_per_rank": rows,
           "cost": {"flops": counts.flops,
                    "bytes accessed": counts.bytes},
           "memory": {"argument_size_in_bytes": mem["exact_bytes"],
                      "output_size_in_bytes": mem["output_bytes"],
                      "temp_size_in_bytes": mem["activations_bytes"]
                      + mem["gathered_params_bytes"]},
           "memory_estimate": mem, "count_s": round(count_s, 3)}
    mf = rl.model_flops(spec, shape, float(n_params))
    if shape.kind != "train":
        kinds = _serve_collectives(params, m, dp, counts)
        coll = _collectives(kinds)
        roof = rl.compute_roofline(counts.flops, counts.bytes,
                                   coll["total_bytes"], chips, mf)
        out.update(collectives=coll, roofline=roof.to_dict())
        return out
    t0 = time.perf_counter()
    sched = train_schedule(params, axes, strategy, fusion_mb,
                           sharding_aware, wire_dtype, selector_mode,
                           selector_table, overlap, codec, error_feedback)
    diags = analysis_verify.verify_schedule(sched)
    kinds = _ir_collectives(sched)
    coll = _collectives(kinds)
    roof = rl.compute_roofline(counts.flops, counts.bytes,
                               coll["total_bytes"], chips, mf)
    analysis = analysis_verify.verify_summary(sched, context=context)
    out.update(collectives=coll, roofline=roof.to_dict(),
               schedule=_schedule_record(sched, roof, diags),
               analysis=analysis,
               verified_static=analysis["n_errors"] == 0,
               plan_s=round(time.perf_counter() - t0, 3))
    return out


# ---------------------------------------------------------------------------
# --trace: the schedule's stages replayed on spawned ranks
# ---------------------------------------------------------------------------

TRACE_REPS = 2
# An allowance for one rank's CUDA context and allocator on the card,
# beside its replay buffers.
CONTEXT_BYTES = 640 * 2 ** 20


def replay_bytes(sched) -> int:
    """One rank's device bytes to replay ``sched``'s most demanding
    stage on ``cuda_ipc`` ranks: four buffers of the stage's size (its
    input, its result and the reducer's working copies; on an H100 the
    largest rank reserved 0.41 and 3.84 GiB replaying smollm-360m's and
    phi-3-vision-4.2b's train_4k on 16 ranks against estimates of 0.35
    and 3.56 GiB) and the channel's receive slots (``dist.SLOTS`` for
    every peer of the group, each sized to the stage's largest hop)."""
    from ..core.dist import SLOTS, slot_bytes
    from ..core.plan_cache import stage_slot_bytes
    from ..core.schedule import DTYPES
    worst = 0
    for _p, _b, st in sched.iter_stages():
        if st.op == "shard":
            continue
        p = int(st.axis_size)
        coded = (getattr(st, "codec", "none") or "none") != "none"
        itemsize = 4 if coded else torch.empty(
            (), dtype=DTYPES[sched.wire_dtype]).element_size()
        n = max(int(st.n_bytes) // itemsize, 1)
        slot = slot_bytes([stage_slot_bytes(st, (n,), itemsize)])
        worst = max(worst, 4 * n * itemsize + SLOTS * (p - 1) * slot)
    return worst


def _trace_groups(sched, world: int) -> dict:
    """A group of the world's first ``s`` ranks for each axis of size
    ``s`` in ``sched`` (``None`` on the ranks outside it); collective
    over the world, in the same order on every rank."""
    import torch.distributed as tdist
    from ..core.dist import Group
    sizes = {}
    for _p, _b, st in sched.iter_stages():
        sizes.setdefault(st.axis, int(st.axis_size))
    groups = {}
    for ax, size in sizes.items():
        pg = None if size == world else tdist.new_group(list(range(size)))
        me = tdist.get_rank()
        groups[ax] = Group(pg, name=ax) if me < size else None
    return groups


def _trace_rank(rank, world, sched, reps, device, attrs):
    """One rank of :func:`trace_schedule`: telemetry on, every distinct
    stage replayed on a group of its axis size."""
    from .. import telemetry
    from ..telemetry import closure
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    tracer = telemetry.configure(telemetry.TelemetryConfig(enabled=True))
    groups = _trace_groups(sched, world)
    with tracer.span("dryrun.trace", cat="wall", **attrs):
        measured = closure.measure_schedule(sched, groups, reps=reps,
                                            device=device)
    peak = torch.cuda.max_memory_reserved() \
        if torch.device(device).type == "cuda" else 0
    if rank:
        return {"peak_bytes": peak}
    return {"measured": measured,
            "metrics": telemetry.METRICS.snapshot(),
            "trace": tracer.to_json(), "peak_bytes": peak}


def trace_schedule(sched, device=None, reps: int = TRACE_REPS,
                   attrs=None) -> dict:
    """Replay every distinct stage of ``sched`` (the closure's probe,
    ``telemetry/closure.py``) on as many spawned ranks as its largest
    axis, each stage on a group of its own axis size: ``cuda_ipc`` ranks
    sharing the card (``device`` None or CUDA), gloo ranks on the host
    (``device="cpu"``).  Returns rank 0's ``measured`` (``{ir_path:
    seconds}``, the slowest rank's), ``metrics`` (``REGISTRY``'s
    snapshot), ``trace`` (its ``repro/trace/v1`` record) and
    ``replay``: the ranks, the estimate of one rank's bytes
    (:func:`replay_bytes`) and each rank's peak reserved bytes.  Raises
    ``ValueError``, naming what to cut, when the ranks' replay cannot
    fit the card's free memory."""
    import tempfile

    from ..core.dist import run_ranks
    from ..kernels.backend import resolve_device

    device = str(resolve_device(device))
    world = max(int(st.axis_size) for _p, _b, st in sched.iter_stages())
    cuda = device.startswith("cuda")
    if cuda:
        free = torch.cuda.mem_get_info()[0]
        need = world * (replay_bytes(sched) + CONTEXT_BYTES)
        if need > free:
            big = max((st for _p, _b, st in sched.iter_stages()),
                      key=lambda st: int(st.n_bytes))
            raise ValueError(
                f"the replay needs ~{need / 2 ** 30:.1f} GiB on {world} "
                f"ranks of one card, {free / 2 ** 30:.1f} GiB free: its "
                f"largest stage ({big.op}@{big.axis}, {big.algorithm}, "
                f"{int(big.n_bytes)} B a rank, channel slots for "
                f"{int(big.axis_size) - 1} peers) does not fit; cut the "
                f"axis size or leave that bucket out")
    with tempfile.TemporaryDirectory() as rdv:
        out = run_ranks(_trace_rank, world,
                        (sched, reps, device, dict(attrs or {})),
                        backend="cuda_ipc" if cuda else "gloo",
                        rendezvous_dir=rdv, threads=1, timeout_s=1800)
    got = dict(out[0])
    got["replay"] = {"ranks": world, "device": device,
                     "estimate_bytes": replay_bytes(sched),
                     "peak_bytes": [o["peak_bytes"] for o in out]}
    del got["peak_bytes"]
    return got


def _attach_trace(rec: dict, spec, shape, axes: dict, trace_path: str,
                  device=None, verbose: bool = True, **plan) -> None:
    """--trace: resolve the train record's schedule exactly as
    :func:`plan_step` does (the model bracket included), replay it on
    spawned ranks with telemetry on (:func:`trace_schedule`), attach
    the closure's residual table as ``rec["measured"]``, the measured
    overlap beside the predicted one as
    ``rec["schedule"]["measured_overlap"]``, the metrics snapshot as
    ``rec["metrics"]``, the replay's ranks and memory as
    ``rec["trace_replay"]``, and write the Perfetto trace to
    ``trace_path``."""
    from .. import telemetry
    from ..models import build_model
    from ..telemetry import closure
    if shape.kind != "train":
        rec["measured"] = {"skipped":
                           "no ReduceSchedule on non-train shapes"}
        return
    params = build_model(spec).init(torch.Generator().manual_seed(0),
                                    "meta").tree()
    sched = train_schedule(params, axes, **plan)
    got = trace_schedule(sched, device=device,
                         attrs={"arch": rec["arch"], "shape": rec["shape"]})
    measured = got["measured"]
    report = closure.closure_report(sched, measured)
    rec["measured"] = report
    compute_s = rec.get("roofline", {}).get("compute_s")
    k = report["calibration"]["k"]
    if rec.get("schedule") and compute_s and k > 0:
        # replay the simulator with the measured per-bucket latencies
        # (calibrated back into model units) so report.py can put a
        # measured overlap fraction next to the predicted one
        tl = closure.measured_timeline(sched, measured, k,
                                       compute_s=float(compute_s))
        rec["schedule"]["measured_overlap"] = {
            "overlap_fraction": tl.overlap_fraction,
            "hidden_comm_s": tl.hidden_comm_s,
            "exposed_comm_s": tl.exposed_comm_s,
            "step_s": tl.step_s,
        }
    rec["metrics"] = got["metrics"]
    rec["trace_replay"] = got["replay"]
    tracer = telemetry.Tracer(telemetry.TelemetryConfig(enabled=True))
    tracer.roots.extend(telemetry.trace.from_json(got["trace"]))
    tracer.write(trace_path)
    if verbose:
        cal = report["calibration"]
        print(f"  trace: {report['n_stages']} stages "
              f"({report['n_gated']} gated) k={cal['k']:.3g} "
              f"max_ratio={report['max_ratio']:.2f} "
              f"within_band={report['all_within_band']} -> {trace_path}")


def run_one(arch: str, shape_name: str, multi_pod: bool,
            strategy: str = "rhd_rsa", fusion_mb: float = 4.0,
            sharding_aware: bool = True, verbose: bool = True,
            remat: bool = False, wire_dtype: str = "",
            spec_overrides=None, selector_mode: str = "analytic",
            selector_table: str = "", overlap: bool = False,
            codec: str = "", error_feedback: bool = False,
            trace_path: str = "", device=None) -> dict:
    """One record.  With ``trace_path``, an OK or SKIP record also gets
    :func:`_attach_trace`'s measured replay on ``device`` (``None``: the
    card); an error there is recorded under ``measured``."""
    from ..configs import SHAPES, get_spec, shape_supported, spec_for_shape
    spec = get_spec(arch)
    ok, why = shape_supported(spec, shape_name)
    mesh = MESHES[multi_pod][0]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
           "strategy": strategy, "fusion_mb": fusion_mb,
           "sharding_aware": sharding_aware, "remat": remat,
           "wire_dtype": wire_dtype, "overlap": overlap,
           "codec": codec or "none", "error_feedback": error_feedback,
           "spec_overrides": spec_overrides or {}}
    plan = dict(strategy=strategy, fusion_mb=fusion_mb,
                sharding_aware=sharding_aware, wire_dtype=wire_dtype,
                selector_mode=selector_mode, selector_table=selector_table,
                overlap=overlap, codec=codec, error_feedback=error_feedback)
    if not ok:
        rec.update(status="SKIP", reason=why)
        if verbose:
            print(f"[dryrun] {arch} × {shape_name} × {mesh}: SKIP ({why})")
    else:
        t0 = time.perf_counter()
        try:
            spec = spec_for_shape(spec, shape_name)
            if remat:
                spec = dataclasses.replace(spec, remat=True)
            if spec_overrides:
                spec = dataclasses.replace(spec, **spec_overrides)
            rec.update(plan_step(spec, SHAPES[shape_name],
                                 mesh_axes(multi_pod),
                                 context=f"{arch}/{shape_name}", **plan))
            rec["status"] = "OK"
            rec["seconds"] = round(time.perf_counter() - t0, 3)
            if verbose:
                _print_ok(rec)
        except Exception as e:  # noqa: BLE001 — recorded, not swallowed
            rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
            if verbose:
                print(f"[dryrun] {arch} × {shape_name} × {mesh}: FAIL {e}")
    if trace_path and rec["status"] in ("OK", "SKIP"):
        try:
            _attach_trace(rec, spec, SHAPES[shape_name],
                          mesh_axes(multi_pod), trace_path, device=device,
                          verbose=verbose, **plan)
        except Exception as e:  # noqa: BLE001 — recorded, not raised
            rec["measured"] = {"error": f"{type(e).__name__}: {e}"}
            if verbose:
                print(f"  trace: FAILED ({e})")
    return rec


def _print_ok(rec):
    rf, mem = rec["roofline"], rec["memory_estimate"]
    print(f"[dryrun] {rec['arch']} × {rec['shape']} × {rec['mesh']}: OK "
          f"({rec['seconds']:.2f} s)")
    print(f"  memory per rank: exact {mem['exact_bytes'] / 2**30:.2f} GiB "
          f"+ gathered {mem['gathered_params_bytes'] / 2**30:.2f} + "
          f"activations {mem['activations_bytes'] / 2**30:.2f} = "
          f"{mem['total_bytes'] / 2**30:.2f} GiB "
          f"({'fits' if mem['fits'] else 'does NOT fit'} "
          f"{hw.H100_SXM.hbm_bytes / 1e9:.0f} GB)")
    print(f"  roofline ({rf['chip']}): compute={rf['compute_s']*1e3:.2f}ms "
          f"memory={rf['memory_s']*1e3:.2f}ms "
          f"collective={rf['collective_s']*1e3:.2f}ms "
          f"dominant={rf['dominant']}")
    sched = rec.get("schedule")
    if sched:
        print(f"  schedule: {sched['n_buckets']} buckets "
              f"[{sched['decomposition']}] verified_static="
              f"{rec['verified_static']}")


def run_all(multi_pod: bool, strategy: str = "rhd_rsa",
            fusion_mb: float = 4.0, sharding_aware: bool = True,
            verbose: bool = True) -> list[dict]:
    """Every arch × shape on one mesh, in this process."""
    from ..configs import SHAPES, list_archs
    return [run_one(arch, shape, multi_pod, strategy, fusion_mb,
                    sharding_aware, verbose=verbose)
            for arch in list_archs() for shape in SHAPES]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--strategy", default="rhd_rsa",
                    help="a reducers.STRATEGIES name, or 'auto' for "
                         "per-bucket message-size-aware selection")
    ap.add_argument("--selector-mode", default="analytic",
                    choices=["analytic", "empirical"])
    ap.add_argument("--selector-table", default="",
                    help="tuning-table JSON for --selector-mode empirical")
    ap.add_argument("--fusion-mb", type=float, default=4.0)
    ap.add_argument("--overlap", action="store_true",
                    help="plan per-bucket reductions inside the backward")
    ap.add_argument("--no-sharding-aware", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--wire-dtype", default="")
    ap.add_argument("--codec", default="",
                    help="wire codec spec (core/codec.py): bf16 | int8 | "
                         "fp8_e4m3, or '<inner>x<outer>' per mesh level")
    ap.add_argument("--error-feedback", action="store_true",
                    help="carry the quantization residual into the next "
                         "step (requires --codec)")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="spec override k=v (int/float/bool literal)")
    ap.add_argument("--json")
    ap.add_argument("--trace", default="",
                    help="write a Perfetto/Chrome trace_event JSON here "
                         "and attach the measured replay's residual table "
                         "(repro_torch.telemetry.closure) to the record: "
                         "every stage replayed on spawned ranks")
    ap.add_argument("--device", default=None,
                    help="where --trace replays: the card (the default; "
                         "cuda_ipc ranks) or cpu (gloo ranks)")
    args = ap.parse_args(argv)

    if args.all:
        out = run_all(args.multi_pod, args.strategy, args.fusion_mb,
                      not args.no_sharding_aware)
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        overrides = {"seq_parallel": True} if args.seq_parallel else {}
        for kv in args.override:
            k, v = kv.split("=", 1)
            try:
                overrides[k] = json.loads(v)
            except json.JSONDecodeError:
                overrides[k] = v
        out = run_one(args.arch, args.shape, args.multi_pod, args.strategy,
                      args.fusion_mb, not args.no_sharding_aware,
                      remat=args.remat, wire_dtype=args.wire_dtype,
                      spec_overrides=overrides or None,
                      selector_mode=args.selector_mode,
                      selector_table=args.selector_table,
                      overlap=args.overlap, codec=args.codec,
                      error_feedback=args.error_feedback,
                      trace_path=args.trace, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    ok = all(r["status"] != "FAIL" for r in
             (out if isinstance(out, list) else [out]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
