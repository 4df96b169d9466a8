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
partial-auto lowering; the port has only the full-manual step) and
``--trace`` (it replays each stage at the mesh's axis size 16, which on
one card means 16 spawned ranks a cell; ROADMAP, Queue 1).

Two fields are not the card's: ``schedule.predicted_comm_s`` and the
timeline under ``schedule.overlap`` come from the cost model, whose
constants are the reference's (``core/cost_model.py``); the roofline's
``collective_s`` is the NVLink charge.  ``memory`` holds one rank's
estimate under the reference's ``memory_analysis`` keys
(``argument_size_in_bytes`` the exact part, ``temp_size_in_bytes`` the
activations and gathered parameters), ``memory_estimate`` its parts.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k \\
      [--multi-pod] [--strategy rhd_rsa] [--json out.json]
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
    agg = _aggregator(strategy, fusion_mb, sharding_aware, wire_dtype,
                      selector_mode, selector_table, overlap, codec,
                      error_feedback, dp_axes, "model" if m > 1 else None)
    sched = resolve_schedule(agg, params, axis_sizes, m)
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


def run_one(arch: str, shape_name: str, multi_pod: bool,
            strategy: str = "rhd_rsa", fusion_mb: float = 4.0,
            sharding_aware: bool = True, verbose: bool = True,
            remat: bool = False, wire_dtype: str = "",
            spec_overrides=None, selector_mode: str = "analytic",
            selector_table: str = "", overlap: bool = False,
            codec: str = "", error_feedback: bool = False) -> dict:
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
    if not ok:
        rec.update(status="SKIP", reason=why)
        if verbose:
            print(f"[dryrun] {arch} × {shape_name} × {mesh}: SKIP ({why})")
        return rec
    t0 = time.perf_counter()
    try:
        spec = spec_for_shape(spec, shape_name)
        if remat:
            spec = dataclasses.replace(spec, remat=True)
        if spec_overrides:
            spec = dataclasses.replace(spec, **spec_overrides)
        rec.update(plan_step(
            spec, SHAPES[shape_name], mesh_axes(multi_pod),
            strategy=strategy, fusion_mb=fusion_mb,
            sharding_aware=sharding_aware, wire_dtype=wire_dtype,
            selector_mode=selector_mode, selector_table=selector_table,
            overlap=overlap, codec=codec, error_feedback=error_feedback,
            context=f"{arch}/{shape_name}"))
        rec["status"] = "OK"
        rec["seconds"] = round(time.perf_counter() - t0, 3)
        if verbose:
            _print_ok(rec)
    except Exception as e:  # noqa: BLE001 — recorded, not swallowed
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[dryrun] {arch} × {shape_name} × {mesh}: FAIL {e}")
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
                      error_feedback=args.error_feedback)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    ok = all(r["status"] != "FAIL" for r in
             (out if isinstance(out, list) else [out]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
