"""ReduceSchedule — the resolved-schedule IR.

Counterpart of ``repro/core/schedule.py``.  :func:`plan` resolves a
gradient tree and an aggregation config into a frozen,
JSON-serialisable :class:`ReduceSchedule` whose ``to_json()`` (schema
``repro/schedule/v1``) and ``fingerprint()`` are byte-identical to the
reference's for the same leaves and config — one bucket per fusion
bucket, each with its decomposition tree of :class:`Stage` s.

This slice plans a single data axis: the fixed strategies ``psum``,
``ring_rsa``, ``rhd_rsa`` and ``ps_gather`` (``hierarchical`` degenerates
to ``ring_rsa`` there, as in the reference), with every codec and the
fused-hop default, and the per-bucket choice of a
:class:`~repro_torch.core.selector.Selector` (``plan(selector=...)``,
``strategy="auto"``), whose switch points align the fusion buckets.
Composed two-level names, multi-axis schedules and the model bracket
raise ``NotImplementedError``.  ``plan(..., cache=)`` interns resolved
schedules in a :class:`~repro_torch.core.plan_cache.PlanCache` keyed by
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
# Composed two-level names (``"<inner>×<outer>"``): the reference's
# per-level choices.  The port parses them (tuning tables may hold
# their measurements) but does not plan them yet.
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
        if name not in reducers.STRATEGIES + ("hierarchical",):
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
    """A flat strategy name (``hierarchical`` is ``ring_rsa`` on one
    axis).  Names that are no strategy (``auto`` among them: the
    selector resolves it before this) raise ValueError; composed and
    multi-axis ``hierarchical`` schedules are not ported yet."""
    if name == "hierarchical" and n_axes == 1:
        return "ring_rsa"
    if len(split_strategy(name)) == 1 and name != "hierarchical":
        return name
    raise NotImplementedError(
        f"strategy {name!r}: composed and hierarchical schedules are not "
        f"ported yet")


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

    def render(self) -> str:
        parts = []
        for st in self.stages:
            if st.op != "allreduce":
                raise NotImplementedError(f"render of {st.op} stages")
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

    def readiness_order(self) -> tuple[int, ...]:
        """Bucket indices in issue order (readiness rank ascending): the
        order the in-backward channel reduces them in."""
        return tuple(sorted(range(len(self.buckets)),
                            key=lambda i: self.buckets[i].readiness_rank))

    def render(self) -> str:
        counts: dict = {}
        for b in self.buckets:
            r = b.render()
            counts[r] = counts.get(r, 0) + 1
        return " + ".join(f"{r}×{n}" if n > 1 else r
                          for r, n in sorted(counts.items()))

    def to_json(self) -> dict:
        """Schema ``repro/schedule/v1`` (the per-bucket form)."""
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
            "fingerprint": self.fingerprint(),
        }
        if self.codec != "none":
            rec["codec"] = self.codec
        if self.error_feedback:
            rec["error_feedback"] = True
        rec["buckets"] = [b.to_json() for b in self.buckets]
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
        blob = json.dumps(struct, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def from_json(rec: dict) -> ReduceSchedule:
    """Rebuild a DETACHED schedule (``plan=None``) from ``to_json``."""
    if rec.get("schema") != SCHEMA:
        raise ValueError(f"schedule schema must be {SCHEMA!r}, "
                         f"got {rec.get('schema')!r}")
    if rec.get("grouped") or rec.get("model_axis"):
        raise NotImplementedError("grouped and model-bracket records are "
                                  "not ported yet")
    buckets = []
    for i, entry in enumerate(rec["buckets"]):
        stages = tuple(Stage(op=s["op"], algorithm=s["algorithm"],
                             axis=s["axis"], axis_size=int(s["axis_size"]),
                             n_bytes=int(s["bytes"]),
                             wire_bytes=int(s["wire_bytes"]),
                             predicted_s=float(s["predicted_s"]),
                             codec=s.get("codec", "none"),
                             fused_hop=bool(s.get("fused_hop", False)))
                       for s in entry["stages"])
        buckets.append(BucketSchedule(
            index=int(entry.get("index", i)),
            leaf_indices=tuple(entry.get("leaf_indices", ())),
            size=int(entry["size"]), n_bytes=int(entry["bytes"]),
            readiness_rank=int(entry["readiness_rank"]),
            strategy=entry["strategy"], stages=stages,
            predicted_s=float(entry["predicted_s"])))
    return ReduceSchedule(
        axis_names=tuple(rec["axis_names"]),
        axis_sizes=tuple(int(s) for s in rec["axis_sizes"]),
        wire_dtype=rec["wire_dtype"], placement=rec["placement"],
        threshold_bytes=int(rec["threshold_bytes"]),
        switch_points=tuple(int(s) for s in rec["switch_points"]),
        buckets=tuple(buckets), codec=rec.get("codec", "none"),
        error_feedback=bool(rec.get("error_feedback", False)), plan=None)


# ---------------------------------------------------------------------------
# Decomposition
# ---------------------------------------------------------------------------

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


def decompose(strategy: str, n_bytes: int, axis_names: Sequence[str],
              axis_sizes: Sequence[int], intra=cost_model.ICI,
              gamma: float = cost_model.GAMMA_S_PER_BYTE,
              codec: str = "none", wire_itemsize: int = 4,
              fused: bool = False) -> tuple[Stage, ...]:
    """The decomposition tree of one bucket on a single data axis: one
    flat allreduce stage."""
    names = tuple(axis_names)
    sizes = tuple(int(s) for s in axis_sizes)
    if len(names) != 1 or len(sizes) != 1:
        raise NotImplementedError(
            f"multi-axis schedules (axes {names}) are not ported yet")
    alg = normalize_strategy(strategy, 1)
    codec_mod.validate_spec(codec)
    return (_flat_allreduce_stage(
        alg, codec or "none", names[0], sizes[0], int(n_bytes),
        cost_model.resolve_link(intra), gamma, int(wire_itemsize),
        fused=fused),)


def strategy_latency(strategy: str, n_bytes: float,
                     axis_sizes: Sequence[int], intra=cost_model.ICI,
                     codec: str = "none", wire_itemsize: int = 4,
                     fused: bool = False) -> float:
    """Cost-model latency of one allreduce of ``n_bytes`` with
    ``strategy`` over ``axis_sizes``: the stage sum of its decomposition
    tree, the selector's argmin objective.  One axis only: the
    reference's ``inter`` (cross-pod) link prices the outer axis of two,
    which is not ported yet."""
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
    ``ScheduleRequest``; the port has one link and no model bracket)."""
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
    link_key: tuple                # (alpha, bandwidth) of the link
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
    returns the identical schedule."""
    if model_axis is not None and int(model_axis_size) > 1:
        raise NotImplementedError("the model bracket is not ported yet")
    names = tuple(axis_names)
    sizes = tuple(int(s) for s in axis_sizes)
    if len(names) != len(sizes):
        raise ValueError(f"axis names {names} / sizes {sizes} mismatch")
    if placement not in PLACEMENTS:
        raise ValueError(f"placement {placement!r} not in {PLACEMENTS}")
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

    def _resolve() -> ReduceSchedule:
        fplan = fusion.build_plan(
            tree, int(threshold_bytes), groups=groups, fuse=fuse,
            switch_points=switch or None, switch_itemsize=wire_itemsize)
        order = overlap_mod.readiness_order(fplan)
        rank = {bi: r for r, bi in enumerate(order)}
        buckets = []
        for i, bucket in enumerate(fplan.buckets):
            n_bytes = int(bucket.size) * wire_itemsize
            predicted = None
            if selector is not None:
                choice = selector.choose(n_bytes, sizes)
                strat = normalize_strategy(choice.strategy, len(names))
                predicted = choice.predicted_s
            else:
                strat = normalize_strategy(strategy, len(names))
            stages = decompose(strat, n_bytes, names, sizes, intra=intra,
                               codec=codec, wire_itemsize=wire_itemsize,
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
            error_feedback=error_feedback, plan=fplan)

    if cache is None:
        return _resolve()
    link = cost_model.resolve_link(intra)
    treedef, shapes, dtypes, gkey = _tree_meta(tree, groups)
    request = ScheduleRequest(
        treedef=treedef, shapes=shapes, dtypes=dtypes, groups_key=gkey,
        threshold_bytes=int(threshold_bytes), fuse=bool(fuse),
        wire_dtype=wire_dtype, axis_names=names, axis_sizes=sizes,
        strategy_context=strategy_context, switch_points=switch,
        placement=placement, link_key=(link.alpha_s, link.bandwidth),
        codec=codec, error_feedback=bool(error_feedback), fused=fused)
    return cache.resolve(request, _resolve)


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
