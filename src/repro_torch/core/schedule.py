"""ReduceSchedule — the resolved-schedule IR.

Counterpart of ``repro/core/schedule.py``.  :func:`plan` resolves a
gradient tree and an aggregation config into a frozen,
JSON-serialisable :class:`ReduceSchedule` whose ``to_json()`` (schema
``repro/schedule/v1``) and ``fingerprint()`` are byte-identical to the
reference's for the same leaves and config — one bucket per fusion
bucket, each with its decomposition tree of :class:`Stage` s.

It plans one dp axis or more (``("pod", "data")``, outermost first):
the flat strategies ``psum``, ``ring_rsa``, ``rhd_rsa`` and
``ps_gather``, which on several axes fold a full allreduce per axis,
innermost first; the composed two-level names ``"<inner>×<outer>"``
(``ring_rsa×{rhd_rsa,ring_rsa,psum}``: ring reduce-scatter over the data
axis, an allreduce of the 1/d chunk across pods, ring all-gather), of
which ``hierarchical`` is ``ring_rsa×rhd_rsa`` on two axes and
``ring_rsa`` on one; every codec, bare or per level (``"bf16×int8"``);
the fused-hop default; and the per-bucket choice of a
:class:`~repro_torch.core.selector.Selector` (``plan(selector=...)``,
``strategy="auto"``), whose switch points align the fusion buckets.
With a model axis (``model_axis``, size > 1; ``core/manual.py``) an
uncoded plan gives each replicated bucket the model bracket: a local
``shard`` opener, the dp stages on the 1/m chunk, and a closing
``all_gather`` over the model axis (``ring@data×rhd@pod×ag@model``).
``plan(..., cache=)`` interns resolved schedules in a
:class:`~repro_torch.core.plan_cache.PlanCache` keyed by
:class:`ScheduleRequest`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Hashable, Sequence

import torch

from .. import tree as tree_mod
from . import codec as codec_mod
from . import cost_model, fusion, overlap as overlap_mod, reducers

SCHEMA = "repro/schedule/v1"
SEP = "×"
PLACEMENTS = ("post_backward", "in_backward")
# Composed two-level names (``"<inner>×<outer>"``): the ring is the only
# reduce-scatter/all-gather; the choice per level is the outer
# (cross-pod) allreduce.
INNER_ALGORITHMS = ("ring_rsa",)
OUTER_ALGORITHMS = ("rhd_rsa", "ring_rsa", "psum")
SHORT_ALG = {"ring_rsa": "ring", "rhd_rsa": "rhd", "psum": "psum",
             "ps_gather": "ps"}

# wire / accumulation dtype names
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def composed_name(inner: str, outer: str) -> str:
    return f"{inner}{SEP}{outer}"


def split_strategy(name: str) -> tuple[str, ...]:
    """``("alg",)`` for a flat strategy, ``("inner", "outer")`` for a
    composed two-level one (ASCII ``x`` accepted); raises ValueError on
    anything else, as the reference does."""
    parts = tuple(name.replace("x", SEP).split(SEP)) \
        if (SEP in name or ("x" in name and name not in
                            reducers.STRATEGIES)) else (name,)
    if len(parts) == 1:
        if name not in reducers.STRATEGIES:
            raise ValueError(f"unknown strategy {name!r}; a flat name "
                             f"from {reducers.STRATEGIES} or a composed "
                             f"'<inner>{SEP}<outer>' name")
        return (name,)
    if len(parts) != 2:
        raise ValueError(f"composed strategy {name!r} must have exactly "
                         f"two levels '<inner>{SEP}<outer>'")
    inner, outer = parts
    if inner not in INNER_ALGORITHMS:
        raise ValueError(f"composed inner level {inner!r} not in "
                         f"{INNER_ALGORITHMS}")
    if outer not in OUTER_ALGORITHMS:
        raise ValueError(f"composed outer level {outer!r} not in "
                         f"{OUTER_ALGORITHMS}")
    return (inner, outer)


def is_strategy(name: str) -> bool:
    try:
        split_strategy(name)
        return True
    except ValueError:
        return False


def normalize_strategy(name: str, n_axes: int) -> str:
    """Resolve aliases against the mesh rank: ``hierarchical`` is
    ``ring_rsa`` on one axis and ``ring_rsa×rhd_rsa`` on two; a composed
    name needs two axes (ValueError, as in the reference)."""
    if name == "hierarchical":
        return "ring_rsa" if n_axes == 1 else \
            composed_name("ring_rsa", "rhd_rsa")
    parts = split_strategy(name)
    if len(parts) == 2 and n_axes != 2:
        raise ValueError(f"composed strategy {name!r} needs a 2-axis "
                         f"mesh, got {n_axes} axis(es)")
    return name


@dataclasses.dataclass(frozen=True)
class Stage:
    """One collective phase of a bucket's decomposition tree."""
    op: str            # "reduce_scatter" | "allreduce" | "all_gather" | "shard"
    algorithm: str
    axis: str
    axis_size: int
    n_bytes: int       # payload entering the stage
    wire_bytes: int    # algorithmic wire bytes on the busiest device
    predicted_s: float
    codec: str = "none"
    fused_hop: bool = False

    def to_json(self) -> dict:
        rec = {"op": self.op, "algorithm": self.algorithm,
               "axis": self.axis, "axis_size": self.axis_size,
               "bytes": self.n_bytes, "wire_bytes": self.wire_bytes,
               "predicted_s": self.predicted_s}
        if self.codec != "none":
            rec["codec"] = self.codec
        if self.fused_hop:
            rec["fused_hop"] = True
        return rec

    @property
    def hlo_kind(self) -> "str | None":
        """The collective family this stage runs as, under the
        reference's names (its wire check's per-kind ledger): explicit
        hops are ``collective-permute``, the vendor ``psum`` is
        ``all-reduce``, the PS pattern ``all-gather``; the bracket's
        local ``shard`` none."""
        if self.op == "shard":
            return None
        if self.algorithm == "psum":
            return "all-reduce"
        if self.algorithm == "ps_gather":
            return "all-gather"
        return "collective-permute"

    @property
    def hlo_bytes(self) -> int:
        """The bytes this stage charges to its kind: the algorithmic wire
        bytes, except one payload for a ``psum`` (the vendor call's
        result size, the reference's convention)."""
        if self.algorithm == "psum":
            return self.n_bytes
        return self.wire_bytes


@dataclasses.dataclass(frozen=True)
class BucketSchedule:
    """One fusion bucket's fully resolved reduction."""
    index: int
    leaf_indices: tuple[int, ...]
    size: int
    n_bytes: int
    readiness_rank: int
    strategy: str
    stages: tuple[Stage, ...]
    predicted_s: float

    @property
    def wire_bytes(self) -> int:
        return sum(st.wire_bytes for st in self.stages)

    @property
    def path(self) -> str:
        """This bucket's IR path, ``bucket[i]``: the key of its telemetry
        span and of the closure's rows."""
        return f"bucket[{self.index}]"

    def stage_path(self, j: int) -> str:
        """The IR path of stage ``j``, ``bucket[i].stage[j]``."""
        return f"{self.path}.stage[{j}]"

    def render(self) -> str:
        """``ring@data×rhd@pod`` for a composed bucket, ``rhd@data`` for
        a flat one (a reduce-scatter/all-gather pair collapses onto its
        level); coded stages carry ``:codec``
        (``ring@data:bf16×rhd@pod:int8``).  The model bracket's closing
        all-gather renders as a level of its own
        (``ring@data×rhd@pod×ag@model``); its ``shard`` opener is
        silent."""
        parts = []
        skip_ag = set()
        for i, st in enumerate(self.stages):
            if i in skip_ag:
                continue
            if st.op == "reduce_scatter":
                for j in range(len(self.stages) - 1, i, -1):
                    other = self.stages[j]
                    if other.op == "all_gather" and other.axis == st.axis:
                        skip_ag.add(j)
                        break
            elif st.op == "all_gather":
                parts.append(f"ag@{st.axis}")
                continue
            elif st.op != "allreduce":
                continue
            part = f"{SHORT_ALG.get(st.algorithm, st.algorithm)}@{st.axis}"
            if st.codec != "none":
                part += f":{codec_mod.get(st.codec).short}"
            parts.append(part)
        return SEP.join(parts)

    def to_json(self) -> dict:
        return {"index": self.index,
                "leaf_indices": list(self.leaf_indices),
                "size": self.size, "bytes": self.n_bytes,
                "readiness_rank": self.readiness_rank,
                "strategy": self.strategy,
                "decomposition": self.render(),
                "wire_bytes": self.wire_bytes,
                "predicted_s": self.predicted_s,
                "stages": [st.to_json() for st in self.stages]}


@dataclasses.dataclass(frozen=True)
class ReduceSchedule:
    """The resolved schedule the aggregator executes."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    wire_dtype: str
    placement: str
    threshold_bytes: int
    switch_points: tuple[int, ...]
    buckets: tuple[BucketSchedule, ...]
    codec: str = "none"
    error_feedback: bool = False
    # The model bracket's axis (not a dp axis, so not in axis_names);
    # emitted and fingerprinted only when set.
    model_axis: "str | None" = None
    model_axis_size: int = 1
    plan: "fusion.FusionPlan | None" = None   # None = detached

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def total_wire_bytes(self) -> int:
        return sum(b.wire_bytes for b in self.buckets)

    @property
    def predicted_s(self) -> float:
        return sum(b.predicted_s for b in self.buckets)

    def strategies(self) -> tuple[str, ...]:
        """Distinct strategy names, sorted."""
        return tuple(sorted({b.strategy for b in self.buckets}))

    def algorithms(self) -> dict:
        """{strategy: bucket count}."""
        out: dict = {}
        for b in self.buckets:
            out[b.strategy] = out.get(b.strategy, 0) + 1
        return out

    def readiness_order(self) -> tuple[int, ...]:
        """Bucket indices in issue order (readiness rank ascending): the
        order the in-backward channel reduces them in."""
        return tuple(sorted(range(len(self.buckets)),
                            key=lambda i: self.buckets[i].readiness_rank))

    def iter_stages(self):
        """``(path, bucket, stage)`` over every stage of every bucket."""
        for b in self.buckets:
            for j, st in enumerate(b.stages):
                yield b.stage_path(j), b, st

    def render(self) -> str:
        counts: dict = {}
        for b in self.buckets:
            r = b.render()
            counts[r] = counts.get(r, 0) + 1
        return " + ".join(f"{r}×{n}" if n > 1 else r
                          for r, n in sorted(counts.items()))

    @property
    def bracketed(self) -> bool:
        return self.model_axis is not None and self.model_axis_size > 1

    def to_json(self, group: bool = False) -> dict:
        """Schema ``repro/schedule/v1``.  ``group=True`` gives the
        reference's grouped form: runs of buckets with the same bytes and
        strategy collapse into one entry with a ``count``, the leaf
        layout is dropped (so the detached fingerprint is embedded), and
        readiness ranks are listed only when they are not reverse plan
        order."""
        rec = {
            "schema": SCHEMA,
            "axis_names": list(self.axis_names),
            "axis_sizes": list(self.axis_sizes),
            "wire_dtype": self.wire_dtype,
            "placement": self.placement,
            "threshold_bytes": self.threshold_bytes,
            "switch_points": list(self.switch_points),
            "n_buckets": self.n_buckets,
            "total_wire_bytes": self.total_wire_bytes,
            "predicted_s": self.predicted_s,
            "decomposition": self.render(),
            "fingerprint": self.fingerprint(detached=group),
        }
        if self.codec != "none":
            rec["codec"] = self.codec
        if self.error_feedback:
            rec["error_feedback"] = True
        if self.bracketed:
            rec["model_axis"] = self.model_axis
            rec["model_axis_size"] = self.model_axis_size
        if not group:
            rec["buckets"] = [b.to_json() for b in self.buckets]
            return rec
        rec["grouped"] = True
        n = len(self.buckets)
        canonical = all(b.readiness_rank == n - 1 - i
                        for i, b in enumerate(self.buckets))
        groups: list[dict] = []
        for b in self.buckets:
            g = b.to_json()
            for drop in ("index", "leaf_indices", "readiness_rank"):
                g.pop(drop)
            if groups and groups[-1]["bytes"] == g["bytes"] \
                    and groups[-1]["strategy"] == g["strategy"]:
                groups[-1]["count"] += 1
                if not canonical:
                    groups[-1]["readiness_ranks"].append(b.readiness_rank)
            else:
                g["count"] = 1
                if not canonical:
                    g["readiness_ranks"] = [b.readiness_rank]
                groups.append(g)
        rec["buckets"] = groups
        return rec

    def fingerprint(self, detached: bool = False) -> str:
        """sha256 of the structural content (not the latencies)."""
        struct = {
            "axis_names": list(self.axis_names),
            "axis_sizes": list(self.axis_sizes),
            "wire_dtype": self.wire_dtype,
            "placement": self.placement,
            "threshold_bytes": self.threshold_bytes,
            "switch_points": list(self.switch_points),
            "buckets": [
                {"leaf_indices": [] if detached
                 else list(b.leaf_indices), "size": b.size,
                 "bytes": b.n_bytes, "readiness_rank": b.readiness_rank,
                 "strategy": b.strategy,
                 "stages": [[st.op, st.algorithm, st.axis, st.axis_size,
                             st.n_bytes, st.wire_bytes]
                            + ([st.codec] if st.codec != "none" else [])
                            + (["fused"] if st.fused_hop else [])
                            for st in b.stages]}
                for b in self.buckets],
        }
        if self.codec != "none":
            struct["codec"] = self.codec
        if self.error_feedback:
            struct["error_feedback"] = True
        if self.bracketed:
            struct["model_axis"] = self.model_axis
            struct["model_axis_size"] = self.model_axis_size
        blob = json.dumps(struct, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def from_json(rec: dict) -> ReduceSchedule:
    """Rebuild a DETACHED schedule (``plan=None``) from ``to_json``
    output, or from the reference's grouped form (``to_json(group=
    True)``), whose entries expand into ``count`` buckets with their
    indices and readiness ranks (reverse plan order unless the record
    lists them)."""
    if rec.get("schema") != SCHEMA:
        raise ValueError(f"schedule schema must be {SCHEMA!r}, "
                         f"got {rec.get('schema')!r}")
    n_total = sum(int(e.get("count", 1)) for e in rec["buckets"])
    buckets = []
    for entry in rec["buckets"]:
        stages = tuple(Stage(op=s["op"], algorithm=s["algorithm"],
                             axis=s["axis"], axis_size=int(s["axis_size"]),
                             n_bytes=int(s["bytes"]),
                             wire_bytes=int(s["wire_bytes"]),
                             predicted_s=float(s["predicted_s"]),
                             codec=s.get("codec", "none"),
                             fused_hop=bool(s.get("fused_hop", False)))
                       for s in entry["stages"])
        ranks = entry.get("readiness_ranks")
        for j in range(int(entry.get("count", 1))):
            i = len(buckets)
            if ranks is not None:
                rank = int(ranks[j])
            elif "readiness_rank" in entry:
                rank = int(entry["readiness_rank"])
            else:
                rank = n_total - 1 - i
            buckets.append(BucketSchedule(
                index=int(entry.get("index", i)),
                leaf_indices=tuple(entry.get("leaf_indices", ())),
                size=int(entry["size"]), n_bytes=int(entry["bytes"]),
                readiness_rank=rank, strategy=entry["strategy"],
                stages=stages, predicted_s=float(entry["predicted_s"])))
    return ReduceSchedule(
        axis_names=tuple(rec["axis_names"]),
        axis_sizes=tuple(int(s) for s in rec["axis_sizes"]),
        wire_dtype=rec["wire_dtype"], placement=rec["placement"],
        threshold_bytes=int(rec["threshold_bytes"]),
        switch_points=tuple(int(s) for s in rec["switch_points"]),
        buckets=tuple(buckets), codec=rec.get("codec", "none"),
        error_feedback=bool(rec.get("error_feedback", False)),
        model_axis=rec.get("model_axis"),
        model_axis_size=int(rec.get("model_axis_size", 1)), plan=None)


# ---------------------------------------------------------------------------
# Decomposition
# ---------------------------------------------------------------------------

def _stage_link(i: int, n_axes: int, intra):
    """Axis 0 of a mesh of several dp axes is the outer (cross-pod)
    level and rides the cross-pod link (:data:`cost_model.DCN`, the
    reference's default); every other axis the intra link."""
    return cost_model.DCN if (n_axes > 1 and i == 0) else intra


def _stage_fused(alg: str, fused: bool) -> bool:
    return bool(fused) and alg in reducers.FUSED_HOP_ALGORITHMS


def _flat_allreduce_stage(alg: str, cname: str, axis: str, p: int,
                          n_bytes: int, link, gamma: float,
                          wire_itemsize: int, fused: bool = False) -> Stage:
    """One flat allreduce stage, coded or not — the reference's
    arithmetic term for term (its committed fingerprints depend on it)."""
    eff = codec_mod.stage_codec(cname, alg)
    fuse = _stage_fused(alg, fused)
    if eff == "none":
        return Stage(
            op="allreduce", algorithm=alg, axis=axis, axis_size=p,
            n_bytes=n_bytes,
            wire_bytes=reducers.wire_bytes(alg, n_bytes, p),
            predicted_s=cost_model.allreduce_latency(
                alg, n_bytes, p, link=link, gamma=gamma),
            fused_hop=fuse)
    enc = codec_mod.encoded_bytes(eff, n_bytes, wire_itemsize)
    hops = reducers.allreduce_steps(alg, p)
    wire = reducers.wire_bytes(alg, enc, p) + codec_mod.hop_bytes(eff, hops)
    predicted = (
        cost_model.allreduce_latency(alg, enc, p, link=link, gamma=0.0)
        + cost_model.allreduce_latency(alg, n_bytes, p,
                                       link=cost_model.FREE_LINK,
                                       gamma=gamma)
        + cost_model.quant_gamma(fuse)
        * reducers.wire_bytes(alg, n_bytes, p))
    return Stage(op="allreduce", algorithm=alg, axis=axis, axis_size=p,
                 n_bytes=n_bytes, wire_bytes=wire, predicted_s=predicted,
                 codec=eff, fused_hop=fuse)


def bracket_chunk_bytes(n_bytes: int, m: int, wire_itemsize: int) -> int:
    """One model rank's chunk of a bracketed bucket: the elements padded
    up to a multiple of ``m`` (the ``shard`` stage pads the buffer), 1/m
    of that payload."""
    elems = max(int(n_bytes) // int(wire_itemsize), 1)
    padded = elems + (-elems) % int(m)
    return (padded // int(m)) * int(wire_itemsize)


def decompose(strategy: str, n_bytes: int, axis_names: Sequence[str],
              axis_sizes: Sequence[int], intra=cost_model.ICI,
              gamma: float = cost_model.GAMMA_S_PER_BYTE,
              codec: str = "none", wire_itemsize: int = 4,
              model_axis: "str | None" = None, model_axis_size: int = 1,
              fused: bool = False) -> tuple[Stage, ...]:
    """The decomposition tree of one bucket over the dp axes (outermost
    first), with the reference's wire bytes and latencies.

    A flat strategy folds a full allreduce per axis, innermost first,
    on any number of axes; a composed one (two axes) runs
    ``reduce_scatter@inner -> allreduce@outer -> all_gather@inner`` (the
    outer level on the 1/d chunk, over the cross-pod link).  ``codec``
    is a bare name for every level or ``"<inner>×<outer>"`` (levels
    innermost first); stages with no hop (psum, ps_gather) carry none.
    ``fused`` marks the accumulating stages that can fuse; the
    all-gather leg only forwards and keeps the unfused toll.

    ``model_axis`` of size > 1 wraps the dp stages in the model bracket:
    a local ``shard`` (no wire), the dp stages on the chunk
    (:func:`bracket_chunk_bytes`), and a ring ``all_gather`` over the
    model axis ((m-1) hops of the chunk on the intra link).  A bracket
    with a wire codec is the reference's ValueError."""
    names = tuple(axis_names)
    sizes = tuple(int(s) for s in axis_sizes)
    if len(names) != len(sizes) or not names:
        raise ValueError(f"axis names {names} / sizes {sizes} mismatch")
    intra = cost_model.resolve_link(intra)
    strategy = normalize_strategy(strategy, len(names))
    parts = split_strategy(strategy)
    n_bytes = int(n_bytes)
    wire_itemsize = int(wire_itemsize)

    m = int(model_axis_size)
    if model_axis is not None and m > 1:
        if (codec or "none") != "none":
            raise ValueError("the model bracket does not compose with "
                             "wire codecs (codec={!r})".format(codec))
        if model_axis in names:
            raise ValueError(f"model axis {model_axis!r} collides with "
                             f"dp axes {names}")
        chunk = bracket_chunk_bytes(n_bytes, m, wire_itemsize)
        inner = decompose(strategy, chunk, names, sizes, intra=intra,
                          gamma=gamma, wire_itemsize=wire_itemsize,
                          fused=fused)
        shard = Stage(op="shard", algorithm="ring_rsa", axis=model_axis,
                      axis_size=m, n_bytes=n_bytes, wire_bytes=0,
                      predicted_s=0.0)
        gather = Stage(op="all_gather", algorithm="ring_rsa",
                       axis=model_axis, axis_size=m, n_bytes=chunk,
                       wire_bytes=(m - 1) * chunk,
                       predicted_s=(m - 1) * intra.alpha_s
                       + (m - 1) * chunk * intra.beta)
        return (shard,) + inner + (gather,)

    if len(parts) == 1:
        (alg,) = parts
        cparts = codec_mod.split_spec(codec, len(names))
        return tuple(
            _flat_allreduce_stage(
                alg, cparts[len(names) - 1 - i], names[i], sizes[i],
                n_bytes, _stage_link(i, len(names), intra), gamma,
                wire_itemsize, fused=fused)
            for i in range(len(names) - 1, -1, -1))

    if len(names) != 2:            # "hierarchical" on three axes
        raise ValueError(f"composed strategy {strategy!r} needs a "
                         f"2-axis mesh, got axes {names}")
    inner_alg, outer_alg = parts
    inner_codec, outer_codec = codec_mod.split_spec(codec, 2)
    inner_eff = codec_mod.stage_codec(inner_codec, inner_alg)
    outer_axis, inner_axis = names
    pods, d = sizes
    stages = []
    frac_d = (d - 1) / d
    rs_fused = _stage_fused(inner_alg, fused)
    if inner_eff != "none":
        enc = codec_mod.encoded_bytes(inner_eff, n_bytes, wire_itemsize)
        level_wire = int(enc * frac_d) + codec_mod.hop_bytes(inner_eff,
                                                             d - 1)
        level_beta_bytes = enc * frac_d
        quant_toll = cost_model.quant_gamma(rs_fused) * n_bytes * frac_d
        ag_quant_toll = cost_model.QUANT_GAMMA_S_PER_BYTE \
            * n_bytes * frac_d
    else:
        level_wire = int(n_bytes * frac_d)
        level_beta_bytes = n_bytes * frac_d
        quant_toll = ag_quant_toll = 0.0
    if d > 1:
        stages.append(Stage(
            op="reduce_scatter", algorithm=inner_alg, axis=inner_axis,
            axis_size=d, n_bytes=n_bytes, wire_bytes=level_wire,
            predicted_s=(d - 1) * intra.alpha_s
            + level_beta_bytes * intra.beta
            + n_bytes * frac_d * gamma + quant_toll,
            codec=inner_eff, fused_hop=rs_fused))
    chunk = n_bytes // d
    if codec_mod.stage_codec(outer_codec, outer_alg) == "none":
        # The reference's uncoded arithmetic: the latency of the FLOAT
        # n_bytes / d beside the int chunk of the wire bytes.
        stages.append(Stage(
            op="allreduce", algorithm=outer_alg, axis=outer_axis,
            axis_size=pods, n_bytes=chunk,
            wire_bytes=reducers.wire_bytes(outer_alg, chunk, pods),
            predicted_s=cost_model.allreduce_latency(
                outer_alg, n_bytes / d, pods, link=cost_model.DCN,
                gamma=gamma),
            fused_hop=_stage_fused(outer_alg, fused)))
    else:
        stages.append(_flat_allreduce_stage(
            outer_alg, outer_codec, outer_axis, pods, chunk, cost_model.DCN,
            gamma,
            wire_itemsize, fused=fused))
    if d > 1:
        stages.append(Stage(
            op="all_gather", algorithm=inner_alg, axis=inner_axis,
            axis_size=d, n_bytes=chunk, wire_bytes=level_wire,
            predicted_s=(d - 1) * intra.alpha_s
            + level_beta_bytes * intra.beta + ag_quant_toll,
            codec=inner_eff))
    return tuple(stages)


def strategy_latency(strategy: str, n_bytes: float,
                     axis_sizes: Sequence[int], intra=cost_model.ICI,
                     codec: str = "none",
                     wire_itemsize: int = 4, fused: bool = False) -> float:
    """Cost-model latency of one allreduce of ``n_bytes`` with
    ``strategy`` over ``axis_sizes`` (outermost first): the stage sum of
    its decomposition tree, the selector's argmin objective."""
    sizes = tuple(int(s) for s in axis_sizes)
    names = tuple(f"ax{i}" for i in range(len(sizes)))
    return sum(st.predicted_s
               for st in decompose(strategy, int(n_bytes), names, sizes,
                                   intra=intra, codec=codec,
                                   wire_itemsize=wire_itemsize,
                                   fused=fused))


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScheduleRequest:
    """Everything that determines a resolved schedule: the plan cache's
    key (``fingerprint()``), derived from the gradient tree itself, so a
    stale schedule is impossible by construction (the reference's
    ``ScheduleRequest``; ``model_key`` is ``(model_axis, m)`` when the
    plan may bracket, else None)."""
    treedef: Hashable
    shapes: tuple
    dtypes: tuple
    groups_key: Hashable
    threshold_bytes: int
    fuse: bool
    wire_dtype: str
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    strategy_context: Hashable     # fixed name, or ("auto", selector
                                   # fingerprint)
    switch_points: tuple[int, ...]
    placement: str
    link_key: tuple                # (alpha, bandwidth) of the intra link
    codec: str = "none"
    error_feedback: bool = False
    model_key: Hashable = None
    fused: bool = False

    def fingerprint(self) -> Hashable:
        return (self.treedef, self.shapes, self.dtypes, self.groups_key,
                self.threshold_bytes, self.fuse, self.wire_dtype,
                self.axis_names, self.axis_sizes, self.strategy_context,
                self.switch_points, self.placement, self.link_key,
                self.codec, self.error_feedback, self.model_key) \
            + (("fused_hops",) if self.fused else ())


def _tree_meta(tree, groups):
    """``(treedef, shapes, dtypes, groups_key)`` of a gradient tree."""
    flat = tree_mod.leaves(tree)
    shapes = tuple(tuple(int(d) for d in x.shape) for x in flat)
    dtypes = tuple(str(x.dtype) for x in flat)
    gkey = None if groups is None else tuple(tree_mod.leaves(groups))
    return tree_mod.structure(tree), shapes, dtypes, gkey


def plan(tree, *, axis_names: Sequence[str], axis_sizes: Sequence[int],
         strategy: str = "rhd_rsa", selector=None,
         threshold_bytes: int = 4 << 20, fuse: bool = True,
         groups=None, wire_dtype: str = "float32",
         align_buckets: bool = True, placement: str = "post_backward",
         intra=cost_model.ICI, codec: str = "none",
         error_feedback: bool = False,
         model_axis: "str | None" = None, model_axis_size: int = 1,
         fused_hops: "bool | None" = None, cache=None) -> ReduceSchedule:
    """Resolve ``tree`` (tensors, or anything with ``.shape``/``.dtype``)
    into a :class:`ReduceSchedule`.  ``selector`` (a
    :class:`~repro_torch.core.selector.Selector`) chooses each bucket's
    strategy and ``predicted_s`` from its wire bytes, and with ``fuse``
    and ``align_buckets`` its switch points align the bucket edges;
    ``strategy`` is the fixed name used when ``selector`` is None.
    ``fused_hops=None`` fuses exactly the coded schedules, as the
    reference does.  ``cache`` (a :class:`~repro_torch.core.plan_cache.
    PlanCache`) interns the result by :class:`ScheduleRequest`: a hit
    returns the identical schedule.

    ``model_axis`` / ``model_axis_size`` (> 1): an uncoded plan brackets
    every replicated-group bucket (its gradients are equal across model
    ranks) over the model axis, priced and chosen on the chunk its dp
    levels move; model-sharded leaves arrive shard-shaped and reduce as
    they are.  A coded plan skips the bracket, as the reference's
    does."""
    names = tuple(axis_names)
    sizes = tuple(int(s) for s in axis_sizes)
    if len(names) != len(sizes):
        raise ValueError(f"axis names {names} / sizes {sizes} mismatch")
    if placement not in PLACEMENTS:
        raise ValueError(f"placement {placement!r} not in {PLACEMENTS}")
    intra = cost_model.resolve_link(intra)
    if wire_dtype not in DTYPES:
        raise ValueError(f"wire dtype {wire_dtype!r} not in {list(DTYPES)}")
    wire_itemsize = DTYPES[wire_dtype].itemsize
    codec = codec or "none"
    codec_mod.validate_spec(codec)
    if error_feedback and codec == "none":
        raise ValueError("error_feedback requires a wire codec")
    fused = (codec != "none") if fused_hops is None else bool(fused_hops)

    switch: tuple[int, ...] = ()
    if selector is not None and fuse and align_buckets:
        switch = tuple(selector.switch_points(
            sizes, hi=max(int(threshold_bytes), 257)))
    strategy_context: Hashable = \
        ("auto", selector.fingerprint()) if selector is not None \
        else normalize_strategy(strategy, len(names))
    model_m = int(model_axis_size)
    may_bracket = (model_axis is not None and model_m > 1
                   and codec == "none")

    def _replicated_group(g) -> bool:
        return g is None or all(e is None for e in tuple(g))

    def _resolve() -> ReduceSchedule:
        fplan = fusion.build_plan(
            tree, int(threshold_bytes), groups=groups, fuse=fuse,
            switch_points=switch or None, switch_itemsize=wire_itemsize)
        order = overlap_mod.readiness_order(fplan)
        rank = {bi: r for r, bi in enumerate(order)}
        buckets = []
        for i, bucket in enumerate(fplan.buckets):
            n_bytes = int(bucket.size) * wire_itemsize
            bracket = may_bracket and _replicated_group(bucket.group)
            dp_bytes = bracket_chunk_bytes(n_bytes, model_m,
                                           wire_itemsize) \
                if bracket else n_bytes
            predicted = None
            if selector is not None:
                choice = selector.choose(dp_bytes, sizes)
                strat = normalize_strategy(choice.strategy, len(names))
                if not bracket:
                    predicted = choice.predicted_s
            else:
                strat = normalize_strategy(strategy, len(names))
            stages = decompose(strat, n_bytes, names, sizes, intra=intra,
                               codec=codec, wire_itemsize=wire_itemsize,
                               model_axis=model_axis if bracket else None,
                               model_axis_size=model_m if bracket else 1,
                               fused=fused)
            if predicted is None:
                predicted = sum(st.predicted_s for st in stages)
            buckets.append(BucketSchedule(
                index=i, leaf_indices=bucket.leaf_indices,
                size=int(bucket.size), n_bytes=n_bytes,
                readiness_rank=rank[i], strategy=strat, stages=stages,
                predicted_s=predicted))
        return ReduceSchedule(
            axis_names=names, axis_sizes=sizes, wire_dtype=wire_dtype,
            placement=placement, threshold_bytes=int(threshold_bytes),
            switch_points=switch, buckets=tuple(buckets), codec=codec,
            error_feedback=error_feedback,
            model_axis=model_axis if may_bracket else None,
            model_axis_size=model_m if may_bracket else 1, plan=fplan)

    if cache is None:
        return _resolve()
    treedef, shapes, dtypes, gkey = _tree_meta(tree, groups)
    request = ScheduleRequest(
        treedef=treedef, shapes=shapes, dtypes=dtypes, groups_key=gkey,
        threshold_bytes=int(threshold_bytes), fuse=bool(fuse),
        wire_dtype=wire_dtype, axis_names=names, axis_sizes=sizes,
        strategy_context=strategy_context, switch_points=switch,
        placement=placement,
        link_key=(intra.alpha_s, intra.bandwidth),
        codec=codec, error_feedback=bool(error_feedback),
        model_key=(model_axis, model_m) if may_bracket else None,
        fused=fused)
    return cache.resolve(request, _resolve)


def synthetic(bucket_bytes: Sequence[float], strategy: str,
              axis_sizes: Sequence[int],
              axis_names: Sequence[str] | None = None,
              intra=cost_model.ICI, latency_fn=None,
              wire_dtype: str = "float32",
              threshold_bytes: int = 0, codec: str = "none",
              model_axis: "str | None" = None,
              model_axis_size: int = 1) -> ReduceSchedule:
    """A DETACHED schedule (``plan=None``) for a list of bucket sizes in
    bytes, as the reference's ``synthetic`` builds one (the cross-pod
    level on its default link, post-backward, no fused hops): bucket
    ``i`` is the ``i``-th from the start of the network, so readiness is
    reverse plan order;
    ``latency_fn(n_bytes)`` overrides each bucket's predicted latency
    (the stages keep the cost model's); a ``model_axis`` of size > 1
    brackets every bucket."""
    sizes = tuple(int(s) for s in axis_sizes)
    names = tuple(axis_names) if axis_names is not None else \
        (("pod", "data") if len(sizes) == 2
         else tuple(f"ax{i}" for i in range(len(sizes))))
    strat = normalize_strategy(strategy, len(names))
    if wire_dtype not in DTYPES:
        raise ValueError(f"wire dtype {wire_dtype!r} not in {list(DTYPES)}")
    itemsize = DTYPES[wire_dtype].itemsize
    codec = codec or "none"
    codec_mod.validate_spec(codec)
    n = len(tuple(bucket_bytes))
    model_m = int(model_axis_size)
    bracket = model_axis is not None and model_m > 1
    buckets = []
    for i, b in enumerate(bucket_bytes):
        n_bytes = int(b)
        stages = decompose(strat, n_bytes, names, sizes, intra=intra,
                           codec=codec, wire_itemsize=itemsize,
                           model_axis=model_axis if bracket else None,
                           model_axis_size=model_m if bracket else 1)
        predicted = float(latency_fn(n_bytes)) if latency_fn is not None \
            else sum(st.predicted_s for st in stages)
        buckets.append(BucketSchedule(
            index=i, leaf_indices=(), size=max(n_bytes // itemsize, 1),
            n_bytes=n_bytes, readiness_rank=n - 1 - i, strategy=strat,
            stages=stages, predicted_s=predicted))
    return ReduceSchedule(
        axis_names=names, axis_sizes=sizes, wire_dtype=wire_dtype,
        placement="post_backward", threshold_bytes=int(threshold_bytes),
        switch_points=(),
        buckets=tuple(buckets), codec=codec,
        model_axis=model_axis if bracket else None,
        model_axis_size=model_m if bracket else 1, plan=None)


def with_fused_hops(sched: ReduceSchedule,
                    fused: bool = True) -> ReduceSchedule:
    """The same schedule with the ``fused_hop`` flag set (or cleared) on
    every stage that can fuse; only the execution route changes."""
    def flip(st: Stage) -> Stage:
        can = (st.op in ("allreduce", "reduce_scatter")
               and st.algorithm in reducers.FUSED_HOP_ALGORITHMS)
        want = bool(fused) and can
        if st.fused_hop == want:
            return st
        return dataclasses.replace(st, fused_hop=want)

    buckets = tuple(
        dataclasses.replace(b, stages=tuple(flip(st) for st in b.stages))
        for b in sched.buckets)
    return dataclasses.replace(sched, buckets=buckets)
