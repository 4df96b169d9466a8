"""Rule engine over the ReduceSchedule IR — static soundness proofs.

Counterpart of ``repro/analysis/verify.py``: the same rules, tables,
messages and locations, run over the port's
:class:`repro_torch.core.schedule.ReduceSchedule` (whose ``to_json`` and
``fingerprint`` equal the reference's), so the two verifiers' summaries
of one schedule are byte-identical.

``SV000``  well-formedness: unique positive axes, known placement,
           parseable wire dtype, parseable strategy names, unique
           bucket indices.
``SV001``  byte conservation: each bucket's stage list matches a fresh
           :func:`repro_torch.core.schedule.decompose` of its strategy,
           and its total equals the ``reducers.wire_bytes`` /
           ``hierarchical_wire_bytes`` closed forms.
``SV002``  reduce_scatter/all_gather pair like parentheses per axis,
           and each mesh axis is reduced exactly once.
``SV003``  bucket leaf indices tile the gradient tree.
``SV004``  readiness ranks are a permutation, monotone in reverse-layer
           order.
``SV005``  no fused bucket straddles a selector crossover point.
``SV006``  a reduced-precision wire dtype has a derivable summation
           bound (:func:`wire_tolerance`).
``SV007``  ``fingerprint()`` does not move with predicted latencies.
``SV008``  codec'd stages carry a codec with a derivable per-hop bound
           (:data:`CODEC_WIRE`), ride ring/RHD hops, and charge the
           encoded bytes plus one 4-byte scale per hop, restated here
           independently of ``core/codec.py``.
``SV009``  ``fused_hop`` rides only accumulating stages
           (:data:`FUSED_HOP_OPS`), and clearing it moves no bound and
           no byte.

Every rule runs on detached schedules (``plan=None``), degrading the
layout rules to what the metadata supports, so a 512-rank schedule is
verified without running it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import reducers
from ..core import schedule as schedule_mod

from . import ERROR, Diagnostic

def _wire_itemsize(name) -> int:
    """Bytes per element of a wire dtype named as torch names it
    (``float32``, ``bfloat16``, ``int8`` ...); TypeError when the name
    is no dtype (what SV000 reports as unparseable)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"data type {name!r} not understood")
    return dt.itemsize


# rule_id -> one-line contract
RULES = {
    "SV000": "schedule is well-formed (axes, placement, dtype, names)",
    "SV001": "stage wire bytes equal the reducers closed forms",
    "SV002": "RS/AG stages pair per axis; axes covered once per level",
    "SV003": "bucket leaf indices partition the gradient tree",
    "SV004": "readiness ranks are monotone in reverse-layer order",
    "SV005": "no fused bucket straddles a selector crossover point",
    "SV006": "reduced-precision wire dtype has a derivable tolerance",
    "SV007": "fingerprint is insensitive to predicted latencies",
    "SV008": "codec'd stages have derivable bounds and encoded bytes",
    "SV009": "fused hops ride accumulating stages; bounds/bytes invariant",
}

# Unit roundoff of the dtypes we allow on the wire: the summation-error
# model |err| <= (log2 p + 1)·eps·|x| (sequential-halving depth of a
# p-way tree reduction) is validated by tests/test_wire_dtype.py for
# bf16; dtypes outside this table have no derivable bound and SV006
# refuses them.
WIRE_EPS = {
    "bfloat16": 2.0 ** -8,
    "float16": 2.0 ** -11,
    "float32": 2.0 ** -24,
    "float64": 2.0 ** -53,
}


def wire_tolerance(sched) -> float | None:
    """Relative summation-error bound of one reduction over the
    schedule's full device product, or None when the wire dtype has no
    entry in :data:`WIRE_EPS` (no derivable bound)."""
    eps = WIRE_EPS.get(str(sched.wire_dtype))
    if eps is None:
        return None
    p = 1
    for s in sched.axis_sizes:
        p *= int(s)
    return (math.log2(max(p, 1)) + 1.0) * eps


# Wire-codec identity table for SV008: codec name -> (payload itemsize
# in bytes/element, carries a per-bucket absmax scale scalar).  This
# RESTATES core/codec.py rather than importing its registry — the
# verifier's byte arithmetic must stay independent of the module it
# audits, so a codec-module regression cannot silently re-derive its
# own bug.  Codecs outside this table have no derivable per-hop error
# bound (core/codec.py tolerance() model) and SV008 refuses them.
CODEC_WIRE = {
    "bf16": (2, False),
    "int8": (1, True),
    "fp8_e4m3": (1, True),
}

# Only algorithms whose hops are explicit ppermutes may carry a codec:
# every hop is a dequantize-reduce-requantize boundary, and psum /
# ps_gather hide their hop structure inside the vendor collective.
CODEC_ALGORITHMS = ("ring_rsa", "rhd_rsa")

# One float32 scale scalar rides each hop of a scaled codec.
CODEC_SCALE_BYTES = 4


def codec_tolerance(sched) -> float | None:
    """Worst-bucket relative error bound of the schedule's wire codecs:
    per codec'd stage, the per-hop model ``hops·eps`` (``·p`` for int8
    absmax growth) of :func:`repro_torch.core.codec.tolerance`, summed over a
    bucket's stages, maxed over buckets.  Hops are ``allreduce_steps``
    for allreduce stages and ``d−1`` for each RS/AG stage.  Returns 0.0
    when nothing is codec'd and ``None`` when any stage carries a codec
    with no derivable bound (the condition SV008 reports)."""
    from ..core import codec as codec_mod
    worst = 0.0
    for b in sched.buckets:
        acc = 0.0
        for st in b.stages:
            cname = getattr(st, "codec", "none")
            if cname == "none":
                continue
            if st.op == "allreduce":
                try:
                    hops = reducers.allreduce_steps(st.algorithm,
                                                    st.axis_size)
                except ValueError:
                    return None
            else:
                hops = st.axis_size - 1
            bound = codec_mod.tolerance(cname, st.axis_size, hops=hops)
            if bound is None:
                return None
            acc += bound
        worst = max(worst, acc)
    return worst


# ---------------------------------------------------------------------------
# closed forms (SV001)
# ---------------------------------------------------------------------------

def closed_form_wire_bytes(strategy: str, n_bytes: int,
                           axis_sizes: tuple[int, ...]) -> int:
    """Total per-device wire bytes the reducers charge for one
    allreduce of ``n_bytes`` — the independent arithmetic SV001 holds
    every bucket's stage sum against."""
    parts = schedule_mod.split_strategy(strategy)
    if len(parts) == 1:
        return reducers.wire_bytes(parts[0], n_bytes, axis_sizes)
    inner, outer = parts
    pods, d = axis_sizes
    if (inner, outer) == ("ring_rsa", "rhd_rsa"):
        levels = reducers.hierarchical_wire_bytes(n_bytes, d=d, pods=pods)
        return levels["intra"] + levels["inter"]
    intra = 0 if d == 1 else 2 * int(n_bytes * (d - 1) / d)
    return intra + reducers.wire_bytes(outer, n_bytes // d, pods)


# ---------------------------------------------------------------------------
# per-rule checkers
# ---------------------------------------------------------------------------

def _rule_sv000(sched, out):
    ok = True

    def err(loc, msg):
        nonlocal ok
        ok = False
        out.append(Diagnostic("SV000", ERROR, loc, msg))

    names, sizes = sched.axis_names, sched.axis_sizes
    if len(names) != len(sizes) or not names:
        err("", f"axis names {names} / sizes {sizes} mismatch")
    if len(set(names)) != len(names):
        err("", f"duplicate mesh axis names {names}")
    for ax, s in zip(names, sizes):
        if int(s) < 1:
            err("", f"axis {ax!r} has non-positive size {s}")
    if sched.placement not in schedule_mod.PLACEMENTS:
        err("", f"placement {sched.placement!r} not in "
                f"{schedule_mod.PLACEMENTS}")
    try:
        _wire_itemsize(sched.wire_dtype)
    except TypeError:
        err("", f"unparseable wire dtype {sched.wire_dtype!r}")
    seen_idx = set()
    for b in sched.buckets:
        if b.index in seen_idx:
            err(b.path, f"duplicate bucket index {b.index}")
        seen_idx.add(b.index)
        try:
            parts = schedule_mod.split_strategy(b.strategy)
            if len(parts) == 2 and len(names) != 2:
                err(b.path, f"composed strategy {b.strategy!r} on a "
                            f"{len(names)}-axis mesh")
        except ValueError as e:
            err(b.path, str(e))
        if b.n_bytes < 0 or b.size < 0:
            err(b.path, f"negative size/bytes ({b.size}/{b.n_bytes})")
    return ok


def _decomposable(sched, bucket) -> bool:
    """Can decompose() resolve this bucket on this mesh?  (SV000 has
    already reported the failure; byte rules skip such buckets.)"""
    try:
        parts = schedule_mod.split_strategy(bucket.strategy)
    except ValueError:
        return False
    return not (len(parts) == 2 and len(sched.axis_names) != 2)


_STAGE_FIELDS = ("op", "algorithm", "axis", "axis_size", "n_bytes",
                 "wire_bytes")


def _bracketed(sched, bucket) -> bool:
    """Does this bucket carry the model bracket (``core/manual.py``)?
    The opener is structural: a bracketed stage list starts with the
    zero-wire ``shard`` op on the schedule's model axis."""
    return (sched.model_axis is not None and sched.model_axis_size > 1
            and bool(bucket.stages) and bucket.stages[0].op == "shard")


def _rule_sv001(sched, out):
    for b in sched.buckets:
        if not _decomposable(sched, b):
            continue
        if _bracketed(sched, b):
            # Re-derive the whole bracket: decompose() itself emits the
            # shard opener, the chunk-sized dp stages, and the terminal
            # model all_gather, so the fresh list is an end-to-end
            # independent derivation of the three-level composition.
            fresh = schedule_mod.decompose(
                b.strategy, b.n_bytes,
                sched.axis_names, sched.axis_sizes,
                wire_itemsize=_wire_itemsize(sched.wire_dtype),
                model_axis=sched.model_axis,
                model_axis_size=sched.model_axis_size)
        else:
            fresh = schedule_mod.decompose(b.strategy, b.n_bytes,
                                           sched.axis_names,
                                           sched.axis_sizes)
        if len(fresh) != len(b.stages):
            out.append(Diagnostic(
                "SV001", ERROR, b.path,
                f"strategy {b.strategy!r} decomposes into {len(fresh)} "
                f"stage(s) on mesh {sched.axis_sizes}, schedule carries "
                f"{len(b.stages)}"))
            continue
        for j, (st, want) in enumerate(zip(b.stages, fresh)):
            coded = getattr(st, "codec", "none") != "none"
            for f in _STAGE_FIELDS:
                if coded and f == "wire_bytes":
                    continue         # encoded accounting: SV008 owns it
                got_v, want_v = getattr(st, f), getattr(want, f)
                if got_v != want_v:
                    out.append(Diagnostic(
                        "SV001", ERROR, b.stage_path(j),
                        f"stage {f}={got_v!r} but "
                        f"{b.strategy!r}@{b.n_bytes}B over "
                        f"{sched.axis_sizes} requires {want_v!r}"))
        if any(getattr(st, "codec", "none") != "none"
               for st in b.stages):
            continue                 # coded buckets: SV008 re-derives
        total = sum(st.wire_bytes for st in b.stages)
        if _bracketed(sched, b):
            # Bracket closed form: the dp levels move the per-model-rank
            # chunk, plus (m-1)/m of the chunked payload for the
            # terminal model all_gather (ring AG of m chunks).
            m = sched.model_axis_size
            chunk = schedule_mod.bracket_chunk_bytes(
                b.n_bytes, m, _wire_itemsize(sched.wire_dtype))
            want_total = closed_form_wire_bytes(
                b.strategy, chunk, sched.axis_sizes) + (m - 1) * chunk
        else:
            want_total = closed_form_wire_bytes(b.strategy, b.n_bytes,
                                                sched.axis_sizes)
        if total != want_total:
            out.append(Diagnostic(
                "SV001", ERROR, b.path,
                f"bucket wire bytes {total} != closed form "
                f"{want_total} ({b.strategy!r}, {b.n_bytes}B, "
                f"mesh {sched.axis_sizes})"))


def _rule_sv002(sched, out):
    mesh = dict(zip(sched.axis_names, sched.axis_sizes))
    if sched.model_axis is not None and sched.model_axis_size > 1:
        # The manual tensor-parallel axis is schedule metadata, not a dp
        # axis: its shard/all_gather bracket obeys the same stack
        # discipline but is excluded from reduce coverage (nothing is
        # ever summed over it).
        mesh[sched.model_axis] = sched.model_axis_size
    for b in sched.buckets:
        stack: list[str] = []
        covered: dict[str, int] = {ax: 0 for ax in sched.axis_names}
        broken = False
        for j, st in enumerate(b.stages):
            loc = b.stage_path(j)
            if st.axis not in mesh:
                out.append(Diagnostic(
                    "SV002", ERROR, loc,
                    f"stage axis {st.axis!r} is not a mesh axis "
                    f"{sched.axis_names}"))
                broken = True
                continue
            if st.axis_size != mesh[st.axis]:
                out.append(Diagnostic(
                    "SV002", ERROR, loc,
                    f"stage axis_size {st.axis_size} != mesh size "
                    f"{mesh[st.axis]} of axis {st.axis!r}"))
            if st.op == "shard":
                # Bracket opener: pushes like reduce_scatter (the
                # terminal model all_gather pops it) but reduces
                # nothing, so it never counts toward coverage.
                stack.append(st.axis)
            elif st.op == "reduce_scatter":
                stack.append(st.axis)
                covered[st.axis] += 1
            elif st.op == "all_gather":
                if not stack or stack[-1] != st.axis:
                    out.append(Diagnostic(
                        "SV002", ERROR, loc,
                        f"all_gather@{st.axis} without a matching open "
                        f"reduce_scatter (pending {stack})"))
                    broken = True
                else:
                    stack.pop()
            elif st.op == "allreduce":
                covered[st.axis] += 1
            else:
                out.append(Diagnostic(
                    "SV002", ERROR, loc, f"unknown stage op {st.op!r}"))
                broken = True
        if stack:
            out.append(Diagnostic(
                "SV002", ERROR, b.path,
                f"unterminated reduce_scatter stage(s) on axes {stack}"))
            broken = True
        if broken or not b.stages:
            continue
        for ax, n in covered.items():
            if n != 1 and not (mesh[ax] == 1 and n == 0):
                out.append(Diagnostic(
                    "SV002", ERROR, b.path,
                    f"mesh axis {ax!r} (size {mesh[ax]}) reduced "
                    f"{n} time(s); must be exactly once"))


def _rule_sv003(sched, out):
    indexed = [b for b in sched.buckets if b.leaf_indices]
    if not indexed:
        return                       # fully detached: no layout to tile
    seen: dict[int, str] = {}
    for b in indexed:
        for i in b.leaf_indices:
            if i in seen:
                out.append(Diagnostic(
                    "SV003", ERROR, b.path,
                    f"leaf {i} already owned by {seen[i]} (overlap)"))
            seen[i] = b.path
    n_leaves = len(sched.plan.leaves) if sched.plan is not None \
        else max(seen) + 1
    missing = sorted(set(range(n_leaves)) - set(seen))
    if missing:
        head = ", ".join(str(i) for i in missing[:8])
        out.append(Diagnostic(
            "SV003", ERROR, "",
            f"{len(missing)} of {n_leaves} gradient leaves are in no "
            f"bucket (gap at {head}{'…' if len(missing) > 8 else ''})"))
    extra = sorted(i for i in seen if i >= n_leaves)
    if extra:
        out.append(Diagnostic(
            "SV003", ERROR, "",
            f"leaf indices {extra[:8]} exceed the gradient tree "
            f"({n_leaves} leaves)"))


def _rule_sv004(sched, out):
    n = len(sched.buckets)
    ranks = sorted(b.readiness_rank for b in sched.buckets)
    if ranks != list(range(n)):
        out.append(Diagnostic(
            "SV004", ERROR, "",
            f"readiness ranks {ranks} are not a permutation of "
            f"0..{n - 1}"))
        return
    if not all(b.leaf_indices for b in sched.buckets):
        return                       # detached: no layout to order by
    by_rank = sorted(sched.buckets, key=lambda b: b.readiness_rank)
    prev = None
    for b in by_rank:
        lo = min(b.leaf_indices)
        if prev is not None and lo >= prev[0]:
            out.append(Diagnostic(
                "SV004", ERROR, b.path,
                f"rank {b.readiness_rank} has min leaf {lo} >= "
                f"{prev[0]} of rank-{prev[1].readiness_rank} "
                f"{prev[1].path}: issue order is not reverse-layer "
                f"(backward produces high-index leaves' grads first)"))
        prev = (lo, b)


def _rule_sv005(sched, out):
    if sched.plan is None or not sched.switch_points:
        return
    itemsize = _wire_itemsize(sched.wire_dtype)
    leaves = sched.plan.leaves
    for b in sched.buckets:
        if len(b.leaf_indices) < 2:
            continue                 # single leaves may span freely
        acc = 0
        for i in b.leaf_indices:
            nb = leaves[i].size * itemsize
            if acc:                  # first leaf opens the bucket
                for s in sched.switch_points:
                    if acc < s < acc + nb:
                        out.append(Diagnostic(
                            "SV005", ERROR, b.path,
                            f"fused bucket grows past the selector "
                            f"crossover at {s}B while appending leaf "
                            f"{i} ({acc}B -> {acc + nb}B): the bucket "
                            f"spans two algorithm regimes"))
            acc += nb


def _rule_sv006(sched, out):
    if not sched.buckets:
        return
    if wire_tolerance(sched) is None:
        out.append(Diagnostic(
            "SV006", ERROR, "",
            f"wire dtype {sched.wire_dtype!r} has no derivable "
            f"summation-tolerance bound (WIRE_EPS covers "
            f"{sorted(WIRE_EPS)})"))


def _perturb_latencies(sched):
    """The same schedule with every predicted latency shifted — what
    a cost-model constant bump does to a re-plan."""
    buckets = tuple(
        dataclasses.replace(
            b, predicted_s=b.predicted_s + 1.0,
            stages=tuple(dataclasses.replace(st,
                                             predicted_s=st.predicted_s
                                             + 1.0)
                         for st in b.stages))
        for b in sched.buckets)
    return dataclasses.replace(sched, buckets=buckets)


def _rule_sv007(sched, out):
    shifted = _perturb_latencies(sched)
    for detached in (False, True):
        if sched.fingerprint(detached=detached) \
                != shifted.fingerprint(detached=detached):
            out.append(Diagnostic(
                "SV007", ERROR, "",
                f"fingerprint(detached={detached}) moves when predicted "
                f"latencies change: re-planning under updated cost-model "
                f"constants would fault the plan cache / trajectory "
                f"diff"))


def _coded_stage_wire_bytes(st, bucket_bytes: int, wire_itemsize: int,
                            itemsize: int, scaled: bool) -> int:
    """Independent re-derivation of one codec'd stage's wire bytes.

    Quantization happens in decoded elements: a stage moving N decoded
    bytes of a ``wire_itemsize``-byte dtype holds ``N // wire_itemsize``
    elements, each ``itemsize`` bytes on the wire once encoded.  The
    algorithmic fraction of those encoded bytes then follows the same
    closed forms SV001 holds uncoded stages to, plus one f32 scale
    scalar per hop for scaled codecs (the per-bucket absmax rides every
    ppermute alongside its payload).

    RS/AG stages are charged from the BUCKET's total bytes (an inner
    ring level moves ``enc·(d−1)/d`` whether scattering or gathering —
    the AG stage's own ``n_bytes`` is the already-divided chunk and
    cannot reproduce decompose's flooring exactly).
    """
    if st.op == "allreduce":
        enc = (st.n_bytes // wire_itemsize) * itemsize
        p = st.axis_size
        if st.algorithm == "ring_rsa":
            wire = int(2 * enc * (p - 1) / p)
            hops = 2 * (p - 1)
        else:                        # rhd_rsa (legality checked first)
            core = 1 << (p.bit_length() - 1)
            wire = int(2 * enc * (core - 1) / core)
            hops = 2 * core.bit_length() - 2
            if core != p:            # MVAPICH2 pre/post fold
                wire += 2 * enc
                hops += 2
        return wire + (hops * CODEC_SCALE_BYTES if scaled else 0)
    # reduce_scatter / all_gather: one ring level of d−1 hops
    d = st.axis_size
    enc = (bucket_bytes // wire_itemsize) * itemsize
    wire = int(enc * (d - 1) / d)
    return wire + ((d - 1) * CODEC_SCALE_BYTES if scaled else 0)


def _rule_sv008(sched, out):
    try:
        wire_itemsize = _wire_itemsize(sched.wire_dtype)
    except TypeError:
        return                       # SV000 already reported the dtype
    for b in sched.buckets:
        for j, st in enumerate(b.stages):
            cname = getattr(st, "codec", "none")
            if cname == "none":
                continue
            loc = b.stage_path(j)
            spec = CODEC_WIRE.get(cname)
            if spec is None:
                out.append(Diagnostic(
                    "SV008", ERROR, loc,
                    f"wire codec {cname!r} has no derivable per-hop "
                    f"error bound (CODEC_WIRE covers "
                    f"{sorted(CODEC_WIRE)})"))
                continue
            if st.algorithm not in CODEC_ALGORITHMS:
                out.append(Diagnostic(
                    "SV008", ERROR, loc,
                    f"codec {cname!r} on algorithm {st.algorithm!r}: "
                    f"only {CODEC_ALGORITHMS} expose per-hop ppermutes "
                    f"to re-quantize at"))
                continue
            itemsize, scaled = spec
            want = _coded_stage_wire_bytes(st, b.n_bytes, wire_itemsize,
                                           itemsize, scaled)
            if st.wire_bytes != want:
                out.append(Diagnostic(
                    "SV008", ERROR, loc,
                    f"codec'd stage wire bytes {st.wire_bytes} != "
                    f"{want} (codec {cname!r}: "
                    f"{st.n_bytes}B decoded / {wire_itemsize}B elems "
                    f"→ {itemsize}B on the wire"
                    f"{' + 4B scale per hop' if scaled else ''})"))


# Fused-hop legality for SV009 — RESTATED independently of
# ``reducers.FUSED_HOP_ALGORITHMS`` (same policy as CODEC_WIRE: the
# verifier's tables must not be derived from the modules it audits).
# The fused hop kernels (K1-K3) fuse decode → fp32 ACCUMULATE → encode,
# so only stages with an accumulating hop (ring/RHD ppermute folds) or an
# accumulating terminal (ps_gather's sum over the gathered axis) can
# carry it.  all_gather/shard move bytes without accumulating and psum
# hides its hops inside the vendor collective — a fused flag there
# names an execution route that does not exist.
FUSED_HOP_OPS = {
    "allreduce": ("ring_rsa", "rhd_rsa", "ps_gather"),
    "reduce_scatter": ("ring_rsa",),
}


def _rule_sv009(sched, out):
    fused_any = False
    for b in sched.buckets:
        for j, st in enumerate(b.stages):
            if not getattr(st, "fused_hop", False):
                continue
            fused_any = True
            loc = b.stage_path(j)
            legal = FUSED_HOP_OPS.get(st.op, ())
            if st.algorithm not in legal:
                out.append(Diagnostic(
                    "SV009", ERROR, loc,
                    f"fused_hop on {st.op}/{st.algorithm}: the fused "
                    f"kernel needs an accumulating hop or terminal "
                    f"reduce (legal: "
                    f"{ {k: v for k, v in FUSED_HOP_OPS.items()} })"))
    if not fused_any:
        return
    # Flag-flip invariance: fusion is an execution ROUTE, not a
    # different reduction — clearing every fused_hop flag must leave
    # the derived error bounds and every stage's byte accounting
    # untouched.  A fused schedule whose tolerance or wire bytes moved
    # would mean the kernel changed the arithmetic contract the static
    # walls certify.
    unfused = schedule_mod.with_fused_hops(sched, False)
    if codec_tolerance(sched) != codec_tolerance(unfused):
        out.append(Diagnostic(
            "SV009", ERROR, "",
            f"codec tolerance moves when fused_hop flags are cleared "
            f"({codec_tolerance(sched)} != "
            f"{codec_tolerance(unfused)}): fused schedules must carry "
            f"the same derived bound as unfused"))
    if wire_tolerance(sched) != wire_tolerance(unfused):
        out.append(Diagnostic(
            "SV009", ERROR, "",
            "wire tolerance moves when fused_hop flags are cleared"))
    for b, ub in zip(sched.buckets, unfused.buckets):
        for j, (st, ust) in enumerate(zip(b.stages, ub.stages)):
            if (st.wire_bytes, st.n_bytes) != (ust.wire_bytes,
                                               ust.n_bytes):
                out.append(Diagnostic(
                    "SV009", ERROR, b.stage_path(j),
                    f"stage bytes change under the fused_hop flag flip "
                    f"(wire {st.wire_bytes} vs {ust.wire_bytes}, "
                    f"decoded {st.n_bytes} vs {ust.n_bytes})"))


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def verify_schedule(sched, context: str = "") -> list[Diagnostic]:
    """Run every SV rule over ``sched``; returns all findings (empty =
    the schedule is statically sound)."""
    out: list[Diagnostic] = []
    _rule_sv000(sched, out)
    # byte/stage rules assume parseable strategies; SV000 already
    # reported unparseable ones and _decomposable skips those buckets
    _rule_sv001(sched, out)
    _rule_sv002(sched, out)
    _rule_sv003(sched, out)
    _rule_sv004(sched, out)
    _rule_sv005(sched, out)
    _rule_sv006(sched, out)
    _rule_sv007(sched, out)
    _rule_sv008(sched, out)
    _rule_sv009(sched, out)
    if context:
        out = [dataclasses.replace(d, context=context) for d in out]
    return out


def verify_summary(sched, context: str = "") -> dict:
    """verify + the record shape dryrun embeds (repro/analysis/v1)."""
    from . import summarize
    diags = verify_schedule(sched, context=context)
    return summarize(diags, extra={
        "fingerprint": sched.fingerprint(),
        "n_buckets": sched.n_buckets,
        "decomposition": sched.render(),
        "axis_sizes": list(sched.axis_sizes),
        "wire_tolerance": wire_tolerance(sched),
        "codec_tolerance": codec_tolerance(sched),
    })
