"""Message-size-aware allreduce algorithm selection (MVAPICH2-style).

Counterpart of ``repro/core/selector.py``, with its names.  The paper's
numbers depend on the message size: RHD beats the vendor library 5-17x
for small and medium messages and trims only ~29% for the largest ones,
which is why MVAPICH2 ships per-(message size, process count) tuning
tables.  A :class:`Selector` maps ``(bucket bytes, axis sizes)`` to a
strategy, so ``strategy="auto"`` gives each fusion bucket its own
algorithm in one step.

``analytic``
    argmin of the cost model (:func:`predict_latency`, the stage sum of
    ``schedule.strategy_latency``) over the candidates; its crossover
    table, computed once per (link, axis sizes), gives the fusion switch
    points.  The constants are the reference's (``hw.V5E``, the link
    profiles of ``cost_model``), so every choice, ``predicted_s`` and
    switch point is bit-identical to the reference's.  They price no
    H100 link: a measured profile waits for the micro-benchmark's table.

``empirical``
    a tuning table measured by ``benchmarks/allreduce_micro.py
    --emit-table`` (JSON, :data:`TABLE_SCHEMA`): the row with the
    nearest process count and the largest message size not above the
    bucket, and its measured argmin.

``ps_gather`` is never selectable (it models the paper's gRPC parameter
server, a baseline).  ``psum`` stays a candidate: it never wins the
analytic argmin (its software alpha), but an empirical table may pick
it; on ``cuda_ipc`` such a bucket runs gloo's host-staged allreduce, as
``psum`` does everywhere in the port.

On a two-axis mesh (``("pod", "data")``) the pool widens to the composed
two-level schedules (:data:`COMPOSED_CANDIDATES`): the choice is per
bucket and per level, the outer level priced on the reference's
cross-pod link (:data:`cost_model.DCN`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Hashable, Mapping, Sequence

from . import codec as codec_mod
from . import cost_model, schedule as schedule_mod

TABLE_SCHEMA = "repro/allreduce-tuning/v1"

# Candidates for one axis; the order breaks ties (the paper's design
# wins equal-latency ties).
DEFAULT_CANDIDATES = ("rhd_rsa", "ring_rsa", "psum")

# Extra candidates on a two-axis mesh: one composed schedule per outer
# (cross-pod) algorithm.
COMPOSED_CANDIDATES = tuple(
    schedule_mod.composed_name("ring_rsa", outer)
    for outer in schedule_mod.OUTER_ALGORITHMS)

LINK_PROFILES = cost_model.LINK_PROFILES
resolve_link = cost_model.resolve_link

MODES = ("analytic", "empirical")


@dataclasses.dataclass(frozen=True)
class Choice:
    strategy: str
    predicted_s: float         # the selector's own latency estimate


def predict_latency(strategy: str, n_bytes: float,
                    axis_sizes: Sequence[int],
                    link: cost_model.LinkParams = cost_model.ICI,
                    codec: str = "none", wire_itemsize: int = 4,
                    fused: bool = False) -> float:
    """Cost-model latency of ``strategy`` (flat, composed, or the
    ``hierarchical`` alias) for one allreduce of ``n_bytes`` over
    ``axis_sizes`` (outermost first): the stage sum of its decomposition
    tree, the outer level of two on :data:`cost_model.DCN`.  ``codec``
    prices the encoded β term and the quantize toll on the algorithms
    that carry it; ``fused`` prices that toll at the fused-hop γ."""
    sizes = tuple(int(s) for s in axis_sizes)
    if len(sizes) > 2:
        raise ValueError(f"selector supports 1- or 2-axis meshes, "
                         f"got {sizes}")
    return schedule_mod.strategy_latency(strategy, n_bytes, sizes,
                                         intra=link, codec=codec,
                                         wire_itemsize=wire_itemsize,
                                         fused=fused)


class Selector:
    """Maps (message bytes, axis sizes) to an allreduce strategy."""

    mode: str = "?"

    def choose(self, n_bytes: int, axis_sizes: Sequence[int]) -> Choice:
        raise NotImplementedError

    def select(self, n_bytes: int, axis_sizes: Sequence[int]) -> str:
        return self.choose(n_bytes, axis_sizes).strategy

    def switch_points(self, axis_sizes: Sequence[int],
                      lo: int = 256, hi: int = 1 << 30) -> tuple[int, ...]:
        """Byte sizes in (lo, hi) at which the chosen algorithm changes;
        fusion aligns bucket edges to them."""
        raise NotImplementedError

    def fingerprint(self) -> Hashable:
        """Identity of the selection function: part of the plan cache's
        key, so plans under different tables or links never collide."""
        raise NotImplementedError


class AnalyticSelector(Selector):
    """argmin of the α-β-γ cost model over the candidate strategies."""

    mode = "analytic"

    def __init__(self, link=cost_model.ICI,
                 candidates: Sequence[str] = DEFAULT_CANDIDATES,
                 codec: str = "none", wire_itemsize: int = 4,
                 fused: bool = False):
        self.link = resolve_link(link)
        for s in candidates:
            if not schedule_mod.is_strategy(s):
                raise ValueError(f"unknown candidate strategy {s!r}")
        self.candidates = tuple(candidates)
        # The wire codec the schedules run under: the argmin prices the
        # encoded β term and the quantize toll (psum, which carries no
        # codec, is priced uncoded); ``fused`` prices the fused hop's γ.
        self.codec = codec or "none"
        codec_mod.validate_spec(self.codec)
        self.wire_itemsize = int(wire_itemsize)
        self.fused = bool(fused)
        self._switch_cache: dict = {}

    def candidates_for(self, axis_sizes: Sequence[int]) -> tuple[str, ...]:
        """On two axes the pool widens to :data:`COMPOSED_CANDIDATES`:
        the argmin is then per bucket and per level."""
        if len(tuple(axis_sizes)) == 2:
            return self.candidates + COMPOSED_CANDIDATES
        return self.candidates

    def choose(self, n_bytes: int, axis_sizes: Sequence[int]) -> Choice:
        sizes = tuple(int(s) for s in axis_sizes)
        best, best_t = None, math.inf
        for s in self.candidates_for(sizes):
            t = predict_latency(s, n_bytes, sizes, self.link,
                                codec=self.codec,
                                wire_itemsize=self.wire_itemsize,
                                fused=self.fused)
            if t < best_t:            # strict: the first listed wins ties
                best, best_t = s, t
        return Choice(best, best_t)

    def switch_points(self, axis_sizes: Sequence[int],
                      lo: int = 256, hi: int = 1 << 30) -> tuple[int, ...]:
        sizes = tuple(int(s) for s in axis_sizes)
        key = (sizes, lo, hi)
        cached = self._switch_cache.get(key)
        if cached is None:
            cached = tuple(b for b, _ in self.crossover_table(sizes, lo, hi)
                           [:-1])
            self._switch_cache[key] = cached
        return cached

    def crossover_table(self, axis_sizes: Sequence[int],
                        lo: int = 256, hi: int = 1 << 30
                        ) -> list[tuple[int, str]]:
        """Piecewise ``(upper_bytes, strategy)`` segments over [lo, hi]:
        a geometric grid, each change of winner bisected to ~1% of its
        bytes (the last segment ends at ``hi``)."""
        sizes = tuple(int(s) for s in axis_sizes)
        grid = []
        n = max(1, lo)
        while n < hi:
            grid.append(n)
            n *= 2
        grid.append(hi)
        segments: list[tuple[int, str]] = []
        prev_n, prev_s = grid[0], self.select(grid[0], sizes)
        for n in grid[1:]:
            s = self.select(n, sizes)
            if s != prev_s:
                a, b = prev_n, n
                while b - a > max(1, a // 128):
                    mid = (a + b) // 2
                    if self.select(mid, sizes) == prev_s:
                        a = mid
                    else:
                        b = mid
                segments.append((b, prev_s))
                prev_s = s
            prev_n = n
        segments.append((hi, prev_s))
        return segments

    def fingerprint(self) -> Hashable:
        # The reference's fingerprint also names its cross-pod link; the
        # port always prices that level on the reference's default (DCN),
        # so it stands here as a constant.
        fp = ("analytic", self.link.alpha_s, self.link.bandwidth,
              cost_model.DCN.alpha_s, cost_model.DCN.bandwidth,
              self.candidates)
        if self.codec != "none":
            fp = fp + (self.codec, self.wire_itemsize)
        if self.fused:
            fp = fp + ("fused_hops",)
        return fp


class EmpiricalSelector(Selector):
    """An MVAPICH2-style measured tuning table (:data:`TABLE_SCHEMA`)."""

    mode = "empirical"

    def __init__(self, table: Mapping, codec: str = "none"):
        validate_table(table)
        self.table = table
        self.codec = codec or "none"
        codec_mod.validate_spec(self.codec)
        # Rows measured under this codec, else the uncoded rows (a table
        # older than the codec must keep resolving).
        have = {e.get("codec", "none") for e in table["entries"]}
        src = self.codec if self.codec in have else \
            ("none" if "none" in have else sorted(have)[0])
        self._codec_rows = src
        # flat rows: p -> [(bytes, {strategy: us})] sorted by bytes; rows
        # with an "axes" list are keyed by those axes.
        self._rows: dict[int, list[tuple[int, dict]]] = {}
        self._axes_rows: dict[tuple[int, ...], list[tuple[int, dict]]] = {}
        for e in table["entries"]:
            if e.get("codec", "none") != src:
                continue
            row = (int(e["bytes"]), dict(e["latency_us"]))
            if e.get("axes"):
                self._axes_rows.setdefault(
                    tuple(int(a) for a in e["axes"]), []).append(row)
            else:
                self._rows.setdefault(int(e["p"]), []).append(row)
        for rows in (*self._rows.values(), *self._axes_rows.values()):
            rows.sort(key=lambda r: r[0])
        self._fp = hashlib.sha256(
            json.dumps(table, sort_keys=True).encode()).hexdigest()[:16]

    def _rows_for(self, axis_sizes: Sequence[int]
                  ) -> list[tuple[int, dict]]:
        sizes = tuple(int(s) for s in axis_sizes)
        if len(sizes) > 1 and sizes in self._axes_rows:
            return self._axes_rows[sizes]
        p = math.prod(sizes)
        if p in self._rows:
            return self._rows[p]
        if not self._rows:
            # an axes-only table: the nearest measured mesh by device
            # count (log distance, ties to the smaller)
            nearest = min(self._axes_rows,
                          key=lambda ax: (abs(math.log(
                              math.prod(ax) / p)), ax))
            return self._axes_rows[nearest]
        # the nearest measured process count (log distance, ties to the
        # smaller)
        nearest = min(self._rows, key=lambda q: (abs(math.log(q / p)), q))
        return self._rows[nearest]

    def choose(self, n_bytes: int, axis_sizes: Sequence[int]) -> Choice:
        sizes = tuple(int(s) for s in axis_sizes)
        rows = self._rows_for(sizes)
        entry = rows[0][1]
        for b, lat in rows:
            if b <= n_bytes:
                entry = lat
            else:
                break
        best, best_t = None, math.inf
        # A table may hold ps_gather's measurements; the baseline is
        # never selected.
        candidates = DEFAULT_CANDIDATES
        if len(sizes) == 2:
            candidates = candidates + COMPOSED_CANDIDATES \
                + ("hierarchical",)
        for s in candidates:
            t = entry.get(s)
            if t is not None and t < best_t:
                best, best_t = s, t
        if best is None:
            raise ValueError(
                f"tuning table has no selectable strategy for "
                f"axes={sizes}, bytes<={n_bytes} "
                f"(candidates {candidates})")
        return Choice(best, best_t * 1e-6)

    def switch_points(self, axis_sizes: Sequence[int],
                      lo: int = 256, hi: int = 1 << 30) -> tuple[int, ...]:
        rows = self._rows_for(tuple(int(s) for s in axis_sizes))
        pts = []
        prev = None
        for b, _ in rows:
            winner = self.select(b, axis_sizes)
            if prev is not None and winner != prev and lo < b < hi:
                pts.append(b)
            prev = winner
        return tuple(pts)

    def fingerprint(self) -> Hashable:
        if self.codec != "none":
            return ("empirical", self._fp, self.codec)
        return ("empirical", self._fp)


# ---------------------------------------------------------------------------
# Tuning tables
# ---------------------------------------------------------------------------

def validate_table(table: Mapping) -> None:
    """Raise ValueError unless ``table`` conforms to TABLE_SCHEMA."""
    if not isinstance(table, Mapping):
        raise ValueError("tuning table must be a JSON object")
    if table.get("schema") != TABLE_SCHEMA:
        raise ValueError(f"tuning table schema must be {TABLE_SCHEMA!r}, "
                         f"got {table.get('schema')!r}")
    entries = table.get("entries")
    if not isinstance(entries, list) or not entries:
        raise ValueError("tuning table needs a non-empty 'entries' list")
    seen = set()
    for e in entries:
        if not isinstance(e, Mapping):
            raise ValueError(f"entry is not an object: {e!r}")
        p, b, lat = e.get("p"), e.get("bytes"), e.get("latency_us")
        if not isinstance(p, int) or p < 1:
            raise ValueError(f"entry 'p' must be a positive int: {e!r}")
        if not isinstance(b, int) or b < 0:
            raise ValueError(f"entry 'bytes' must be a non-negative int: "
                             f"{e!r}")
        axes = e.get("axes")
        if axes is not None:
            if (not isinstance(axes, list) or len(axes) < 2
                    or any(not isinstance(a, int) or a < 1 for a in axes)):
                raise ValueError(f"entry 'axes' must be a list of >= 2 "
                                 f"positive ints: {e!r}")
            if math.prod(axes) != p:
                raise ValueError(f"entry 'axes' {axes} product != p={p}")
        codec = e.get("codec", "none")
        if not isinstance(codec, str):
            raise ValueError(f"entry 'codec' must be a string: {e!r}")
        try:
            codec_mod.validate_spec(codec)
        except ValueError as err:
            raise ValueError(f"entry (p={p}, bytes={b}): {err}")
        key = (p, tuple(axes) if axes else None, b, codec)
        if key in seen:
            raise ValueError(f"duplicate (p={p}, axes={axes}, bytes={b}, "
                             f"codec={codec}) entry")
        seen.add(key)
        if not isinstance(lat, Mapping) or not lat:
            raise ValueError(f"entry 'latency_us' must be a non-empty "
                             f"object: {e!r}")
        for s, us in lat.items():
            if not schedule_mod.is_strategy(s):
                raise ValueError(f"unknown strategy {s!r} in entry "
                                 f"(p={p}, bytes={b})")
            if not isinstance(us, (int, float)) or not math.isfinite(us) \
                    or us <= 0:
                raise ValueError(f"latency_us[{s!r}] must be a finite "
                                 f"positive number, got {us!r}")


def load_table(path: str) -> dict:
    with open(path) as f:
        table = json.load(f)
    validate_table(table)
    return table


def save_table(table: Mapping, path: str) -> None:
    validate_table(table)
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")


def build_analytic_table(ps: Sequence[int], sizes: Sequence[int],
                         link=cost_model.ICI,
                         candidates: Sequence[str] = DEFAULT_CANDIDATES
                         ) -> dict:
    """A tuning table filled from the cost model (deterministic)."""
    link = resolve_link(link)
    entries = []
    for p in ps:
        for n in sizes:
            entries.append({
                "p": int(p), "bytes": int(n),
                "latency_us": {
                    s: cost_model.allreduce_latency(s, n, p, link=link) * 1e6
                    for s in candidates},
            })
    link_name = next((k for k, v in LINK_PROFILES.items() if v == link),
                     "custom")
    return {"schema": TABLE_SCHEMA, "link": link_name, "entries": entries}


def crossover_bytes(p: int, link=cost_model.ICI,
                    candidates: Sequence[str] = DEFAULT_CANDIDATES,
                    lo: int = 1, hi: int = 1 << 32,
                    codec: str = "none", fused: bool = False) -> float:
    """The message size at which the analytic winner stops being
    ``rhd_rsa``: 0 if RHD never wins (p = 3, where the pre/post fold
    erases its step advantage), ``inf`` if it always wins (power-of-two
    p).  A codec keeps RHD competitive to larger messages, and so does
    the fused hop's cheaper toll."""
    sel = AnalyticSelector(link=link, candidates=candidates, codec=codec,
                           fused=fused)
    if sel.select(lo, (p,)) != "rhd_rsa":
        return 0.0
    if sel.select(hi, (p,)) == "rhd_rsa":
        return math.inf
    a, b = lo, hi
    while b - a > max(1, a // 256):
        mid = (a + b) // 2
        if sel.select(mid, (p,)) == "rhd_rsa":
            a = mid
        else:
            b = mid
    return float(b)


def make_selector(mode: str = "analytic", table=None, link=cost_model.ICI,
                  candidates: Sequence[str] = DEFAULT_CANDIDATES,
                  codec: str = "none", wire_itemsize: int = 4,
                  fused: bool = False) -> Selector:
    """The aggregator's factory: ``table`` is a path or a parsed dict
    (empirical mode only).  ``codec`` makes the argmin price the coded
    wire (analytic) or read the codec's rows (empirical); ``fused``
    prices the fused-hop γ (analytic only: a table's rows already hold
    the path they were measured on)."""
    if mode == "analytic":
        return AnalyticSelector(link=link, candidates=candidates,
                                codec=codec, wire_itemsize=wire_itemsize,
                                fused=fused)
    if mode == "empirical":
        if table is None:
            raise ValueError("empirical selector mode needs a tuning table "
                             "(selector_table=path or dict)")
        if isinstance(table, str):
            table = load_table(table)
        return EmpiricalSelector(table, codec=codec)
    raise ValueError(f"unknown selector mode {mode!r}; one of {MODES}")
