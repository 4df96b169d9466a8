"""Collective lint over a hop log — rules ``HL0xx``.

Counterpart of ``repro/analysis/hlo_lint.py``.  The reference lints the
compiled HLO of a step; the port has no HLO, but it has the hops it
actually ran.  A **hop log** (:func:`hop_log`) is one record per
collective a step sent, read from its telemetry spans (``REPRO_TRACE``):
the ``hop[k]`` spans the reducers open around every ppermute, and the
``psum`` / ``all_gather`` spans of the vendor collectives.  The bytes
and element type in a record are what the transport was handed to send
(``core/dist.py`` records them there, after encode, scales included),
never re-derived from the IR, which is what the rules hold them to:

``HL001``  per stage, the bytes this rank's hops sent cover the IR's
           ``hlo_bytes`` within ``rel_tol`` (the wire check).
``HL002``  ``placement="in_backward"`` must overlap: at least one whole
           bucket's hops were issued before the backward ended.
``HL003``  every hop of a stage sends one element type, the stage's
           wire dtype (the codec's payload type on a coded stage).
``HL004``  *warn*: a vendor all-reduce (``dist.psum``) ran inside an
           aggregate whose schedule has no ``psum`` stage.
``HL005``  on a schedule with fused coded stages, the float32 bytes on
           the wire stay within :func:`fused_f32_permute_budget`: the
           uncoded hops' bytes plus one 4-byte scale per encoded block
           of a fused coded hop.  An f32 hop carrying a coded payload
           means the codec's bandwidth win is gone.

:func:`wire_check` is the reference's, verbatim: given per-kind bytes
(:func:`charged_bytes` of a hop log) it returns the same dict.

Warning baseline: ``baseline.json`` beside this module (schema
``repro/analysis-baseline/v1``, the reference's format, empty) lists
accepted warnings as ``{"rule_id": ..., "context": ...}`` entries
(``"*"`` matches every context); errors are never baselinable.
"""
from __future__ import annotations

import json
import os

from ..telemetry import trace as trace_mod
from . import ERROR, WARN, Diagnostic

RULES = {
    "HL001": "bytes the hops sent cover the IR per-stage bytes",
    "HL002": "in_backward schedules issue >=1 whole bucket before the "
             "backward ends",
    "HL003": "every hop of a stage sends the stage's wire dtype",
    "HL004": "no vendor all-reduce inside an aggregate without a psum "
             "stage (warn)",
    "HL005": "fused codec'd schedules keep f32 wire bytes within the "
             "scale-scalar budget",
}

BASELINE_SCHEMA = "repro/analysis-baseline/v1"
BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")

# The payload element type of each codec on the wire, restated here
# independently of core/codec.py (the lint must not derive its
# expectations from the module it audits).
CODEC_DTYPE = {"bf16": "bfloat16", "int8": "int8",
               "fp8_e4m3": "float8_e4m3fn"}
SCALED_CODECS = ("int8", "fp8_e4m3")
SCALE_BYTES = 4


# ---------------------------------------------------------------------------
# wire_check — the reference's, verbatim (same dict on the same inputs)
# ---------------------------------------------------------------------------

def wire_check(sched, collective_bytes, rel_tol: float = 0.02) -> dict:
    """Measured-vs-modeled comm-byte consistency: compare per-kind
    charged collective bytes against the per-STAGE wire bytes carried by
    the resolved :class:`repro_torch.core.schedule.ReduceSchedule`.

    ``collective_bytes``: the per-kind byte dict (here
    :func:`charged_bytes` of a hop log).  Each stage predicts its kind
    (``Stage.hlo_kind``) and the bytes it charges (``Stage.hlo_bytes``).
    The charged side may legitimately exceed the prediction (padding on
    non-divisible chunks, per-block scales), so the verdict is per kind:
    ``consistent`` = every predicted kind is within ``rel_tol`` below
    the charge it explains or lower.
    """
    predicted: dict = {}
    for bucket in sched.buckets:
        for st in bucket.stages:
            if st.hlo_kind is None:
                continue             # "shard" bracket opener: local
            predicted[st.hlo_kind] = predicted.get(st.hlo_kind, 0) \
                + st.hlo_bytes
    charged = {k: int(v) for k, v in collective_bytes.items()}
    kinds = {}
    for kind, want in sorted(predicted.items()):
        got = charged.get(kind, 0)
        kinds[kind] = {
            "predicted": int(want), "charged": got,
            "ratio": (got / want) if want else None,
            # charged >= predicted*(1-tol): the schedule's bytes are in
            # the charge (extra charge from other collectives is allowed)
            "ok": got >= want * (1.0 - rel_tol),
        }
    return {
        "axis_sizes": list(sched.axis_sizes),
        "predicted_total": int(sum(predicted.values())),
        "charged_total": int(sum(charged.values())),
        "kinds": kinds,
        "consistent": all(k["ok"] for k in kinds.values()),
    }


# ---------------------------------------------------------------------------
# the hop log
# ---------------------------------------------------------------------------

def hop_log(spans, rank: int = 0) -> list[dict]:
    """One record per collective sent under ``spans`` (a span forest,
    :class:`~repro_torch.telemetry.trace.Span` s or a ``repro/trace/v1``
    record), in the order they were opened:

    ``rank``, ``ir_path`` (``bucket[i].stage[j].hop[k]``; the stage's
    path for a vendor collective), ``stage`` and ``bucket`` paths,
    ``kind`` (``collective-permute``, ``all-reduce``, ``all-gather``),
    ``sent_bytes``, ``dtype`` (the payload's, None when this rank sent
    nothing on the hop), ``parts`` (``[dtype, bytes]`` per tensor sent),
    host ``t0``/``t1``, and ``aggregate``: ``"aggregate[n]"`` for the
    n-th ``aggregate`` span, ``"in_backward"`` for a bucket the overlap
    channel reduced, None outside both."""
    if isinstance(spans, dict):
        spans = trace_mod.from_json(spans)
    out: list[dict] = []
    n_agg = [0]

    def visit(span, agg, stage):
        path = span.attrs.get("ir_path", "")
        if span.name == "aggregate":
            agg = f"aggregate[{n_agg[0]}]"
            n_agg[0] += 1
        elif agg is None and span.name.startswith("bucket[") and path:
            agg = "in_backward"
        if span.name.startswith("stage[") and path:
            stage = path
        if "sent_bytes" in span.attrs:
            own = path or stage
            out.append({
                "rank": rank, "ir_path": own, "stage": stage,
                "bucket": stage.split(".stage[")[0] if stage else "",
                "kind": span.attrs.get("kind", ""),
                "sent_bytes": int(span.attrs["sent_bytes"]),
                "dtype": span.attrs.get("sent_dtype"),
                "parts": [list(p) for p in span.attrs.get("sent_parts",
                                                          [])],
                "t0": span.t0, "t1": span.t1, "aggregate": agg})
        for child in span.children:
            visit(child, agg, stage)

    for root in spans:
        visit(root, None, "")
    return out


def _ranks(log) -> list:
    return sorted({r["rank"] for r in log})


def charged_bytes(log) -> dict:
    """Per-kind bytes sent inside aggregates, on the busiest rank of
    the log: the ``collective_bytes`` :func:`wire_check` takes."""
    per: dict = {}
    for r in log:
        if r["aggregate"] is None:
            continue
        key = (r["rank"], r["kind"])
        per[key] = per.get(key, 0) + r["sent_bytes"]
    out: dict = {}
    for (_, kind), n in per.items():
        out[kind] = max(out.get(kind, 0), n)
    return out


def stage_sent_bytes(log) -> dict:
    """``{stage path: bytes}`` the hops of each stage sent, on the
    busiest rank of the log."""
    per: dict = {}
    for r in log:
        if r["stage"]:
            key = (r["rank"], r["stage"])
            per[key] = per.get(key, 0) + r["sent_bytes"]
    out: dict = {}
    for (_, stage), n in per.items():
        out[stage] = max(out.get(stage, 0), n)
    return out


# ---------------------------------------------------------------------------
# per-stage hop accounting
# ---------------------------------------------------------------------------

def stage_hops(st) -> tuple[int, int, int]:
    """``(accumulating hops, forwarding hops, forwarded blocks)`` a stage
    makes on every rank: a ring reduce-scatter d-1 accumulating, an
    all-gather d-1 forwarding (one block each); an allreduce its
    reduce-scatter and all-gather halves (RHD over log2 of its pow2
    core, plus the pre-fold and post-broadcast of a non-pow2 size, whose
    forwarding hops carry 1, 2, .. core/2 chunks, then core, each at its
    own scale on a scaled codec); psum, ps_gather and the model
    bracket's local shard none."""
    p = st.axis_size
    if p == 1 or st.algorithm in ("psum", "ps_gather") or st.op == "shard":
        return 0, 0, 0
    if st.op == "reduce_scatter":
        return p - 1, 0, 0
    if st.op == "all_gather":
        return 0, p - 1, p - 1
    if st.algorithm == "ring_rsa":
        return p - 1, p - 1, p - 1
    core = 1 << (p.bit_length() - 1)
    levels = core.bit_length() - 1
    fold = int(core != p)
    return levels + fold, levels + fold, core - 1 + fold * core


def _codec(st) -> str:
    return getattr(st, "codec", "none") or "none"


def exact_sent_bytes(st) -> int:
    """The bytes the hops of stage ``st`` send on every rank when its
    payload splits evenly over the ranks (nothing padded): the IR's
    bytes, its scale charge of one 4-byte scale per hop replaced, on a
    scaled codec, by one per encoded block (:func:`stage_hops`).  A
    codec that sent its payload twice, padded it or dropped part of it
    misses this by at least a byte, where HL001 allows ``rel_tol``."""
    if _codec(st) not in SCALED_CODECS:
        return st.hlo_bytes
    _acc, fwd, blocks = stage_hops(st)
    return st.hlo_bytes + SCALE_BYTES * (blocks - fwd)


def fused_f32_permute_budget(sched) -> int:
    """Upper bound on LEGITIMATE f32 hop bytes of a fused codec'd
    schedule: uncoded (or unfused) hop stages move their full payload,
    and each fused coded hop carries one 4-byte f32 scale per block it
    encodes (one per accumulating hop; per forwarding hop one per chunk
    it joins)."""
    budget = 0
    for b in sched.buckets:
        for st in b.stages:
            if st.hlo_kind != "collective-permute":
                continue
            coded = _codec(st) != "none"
            if coded and getattr(st, "fused_hop", False):
                acc, _, blocks = stage_hops(st)
                if _codec(st) in SCALED_CODECS:
                    budget += (acc + blocks) * SCALE_BYTES
            else:
                budget += st.hlo_bytes
    return budget


def f32_permute_bytes(log) -> int:
    """Float32 bytes the hops sent, on the busiest rank of the log (the
    measured side of HL005)."""
    per: dict = {}
    for r in log:
        if r["kind"] != "collective-permute":
            continue
        n = sum(b for dt, b in r["parts"] if dt == "float32")
        per[r["rank"]] = per.get(r["rank"], 0) + n
    return max(per.values(), default=0)


def overlap_witness(log, backward_end) -> tuple[int, int]:
    """``(buckets whose hops all ended before the backward did, buckets
    with hops)``, summed over the log's ranks; ``backward_end`` is a
    ``time.perf_counter()`` value (``OverlapRecord.backward_end``) or
    ``{rank: value}``."""
    last: dict = {}
    for r in log:
        if r["kind"] != "collective-permute" or not r["bucket"]:
            continue
        key = (r["rank"], r["aggregate"], r["bucket"])
        last[key] = max(last.get(key, r["t1"]), r["t1"])
    before = 0
    for (rank, _, _), t1 in last.items():
        end = backward_end[rank] if isinstance(backward_end, dict) \
            else backward_end
        before += t1 <= end
    return before, len(last)


def _wire_dtype(sched, bucket, st) -> str:
    """The element type the stage's hops must send."""
    if _codec(st) != "none":
        return CODEC_DTYPE.get(_codec(st), _codec(st))
    # a coded bucket runs every stage in float32
    if any(_codec(s) != "none" for s in bucket.stages):
        return "float32"
    return sched.wire_dtype


# ---------------------------------------------------------------------------
# the lint pass
# ---------------------------------------------------------------------------

def lint_hops(sched, log, backward_end=None, rel_tol: float = 0.02,
              context: str = "") -> list[Diagnostic]:
    """Run every HL rule over ``log`` (:func:`hop_log` of the steps that
    executed ``sched``, from one rank or several).  HL002 runs when the
    schedule is in-backward and ``backward_end`` is given."""
    out: list[Diagnostic] = []

    sent = stage_sent_bytes(log)
    for path, _b, st in sched.iter_stages():
        if st.hlo_kind is None or not st.hlo_bytes:
            continue
        got, want = sent.get(path, 0), st.hlo_bytes
        if got < want * (1.0 - rel_tol):
            out.append(Diagnostic(
                "HL001", ERROR, path,
                f"hops sent {got}B of {st.hlo_kind} but the IR's stage "
                f"charges {want}B (ratio {got / want:.3f} < "
                f"1-{rel_tol})", context=context))

    if sched.placement == "in_backward" and backward_end is not None:
        before, total = overlap_witness(log, backward_end)
        if total and not before:
            out.append(Diagnostic(
                "HL002", ERROR, "",
                f"placement='in_backward' but none of {total} buckets "
                f"issued all its hops before the backward ended: the "
                f"reductions serialized into a trailing block",
                context=context))

    dtypes: dict = {}
    for r in log:
        if r["dtype"] is not None and r["stage"]:
            dtypes.setdefault(r["stage"], set()).add(r["dtype"])
    for path, b, st in sched.iter_stages():
        got = dtypes.get(path)
        want = _wire_dtype(sched, b, st)
        if got and got != {want}:
            out.append(Diagnostic(
                "HL003", ERROR, path,
                f"hops send {'/'.join(sorted(got))} where the stage's "
                f"wire dtype is {want}: the wire-dtype byte accounting "
                f"no longer holds", context=context))

    fused_coded = any(getattr(st, "fused_hop", False)
                      and _codec(st) != "none"
                      for b in sched.buckets for st in b.stages)
    if fused_coded:
        got = f32_permute_bytes(log)
        budget = fused_f32_permute_budget(sched)
        allowed = budget + max(1024, budget // 100)
        if got > allowed:
            out.append(Diagnostic(
                "HL005", ERROR, "collective-permute",
                f"fused codec'd schedule moves {got}B of f32 hop payload "
                f"but only {budget}B are legitimate (uncoded payloads + "
                f"one 4B scale per fused coded block): the coded wire "
                f"decayed to f32", context=context))

    expects_ar = any(st.hlo_kind == "all-reduce"
                     for b in sched.buckets for st in b.stages)
    vendor = [r for r in log if r["kind"] == "all-reduce"
              and r["aggregate"] is not None]
    if vendor and not expects_ar and sched.buckets:
        n = sum(r["sent_bytes"] for r in vendor)
        out.append(Diagnostic(
            "HL004", WARN, "all-reduce",
            f"schedule decomposes into RSA/permute stages only, but "
            f"{len(vendor)} vendor all-reduce call(s) sent {n}B inside "
            f"the aggregate: a collective outside the schedule",
            context=context))
    return out


# ---------------------------------------------------------------------------
# warning baseline
# ---------------------------------------------------------------------------

def load_baseline(path: str | None = None) -> list[dict]:
    """Accepted-warning entries of the baseline file (this package's
    ``baseline.json`` by default); [] when the file does not exist."""
    if path is None:
        path = BASELINE_FILE
    if not os.path.exists(path):
        return []
    with open(path) as f:
        rec = json.load(f)
    if rec.get("schema") != BASELINE_SCHEMA:
        raise ValueError(f"baseline schema must be {BASELINE_SCHEMA!r}, "
                         f"got {rec.get('schema')!r}")
    return list(rec.get("warnings", []))


def baselined(diag: Diagnostic, baseline: list[dict]) -> bool:
    """Does an accepted-warning entry cover this diagnostic?  Errors
    are never baselinable."""
    if diag.severity != WARN:
        return False
    for entry in baseline:
        if entry.get("rule_id") != diag.rule_id:
            continue
        ctx = entry.get("context", "*")
        if ctx in ("*", diag.context):
            return True
    return False


def unbaselined_warnings(diags, baseline: list[dict]) -> list[Diagnostic]:
    return [d for d in diags
            if d.severity == WARN and not baselined(d, baseline)]
