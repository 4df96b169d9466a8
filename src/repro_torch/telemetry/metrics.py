"""Process-local metrics registry: counters, gauges, histograms.

Counterpart of ``repro/telemetry/metrics.py``, with its names, schema
and snapshot format.  Stdlib only, so the lowest core modules import it
without cycles.  Instrumentation sites guard on
:func:`repro_torch.telemetry.trace.enabled`, so with telemetry off the
registry stays empty and nothing in a hot path pays for it.  The
registry is written from the thread that resolves and steps (the
overlap channel records spans, never metrics).

Snapshots are plain JSON (schema ``repro/metrics/v1``); label sets are
flattened into stable ``key=value,...`` strings so the snapshot
round-trips without custom decoding.  Histograms keep a bounded
reservoir of raw observations and report count/sum plus percentiles —
enough for step-time p50/p90/p99 without binning decisions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

METRICS_SCHEMA = "repro/metrics/v1"

KINDS = ("counter", "gauge", "histogram")

# Reservoir cap per (histogram, labelset): old observations are dropped
# FIFO.  Large enough for every step of any run this repo does.
MAX_SAMPLES = 4096


def label_key(labels: Dict[str, Any]) -> str:
    """Canonical flat form of a label set: ``"a=1,b=x"`` (sorted)."""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list (q in [0, 100])."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


@dataclasses.dataclass
class Counter:
    name: str
    help: str = ""
    kind: str = "counter"
    values: Dict[str, float] = dataclasses.field(default_factory=dict)

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(amount={amount})")
        key = label_key(labels)
        self.values[key] = self.values.get(key, 0.0) + amount

    def get(self, **labels) -> float:
        return self.values.get(label_key(labels), 0.0)

    def snapshot(self) -> dict:
        return {"kind": self.kind, "help": self.help,
                "values": dict(self.values)}


@dataclasses.dataclass
class Gauge:
    name: str
    help: str = ""
    kind: str = "gauge"
    values: Dict[str, float] = dataclasses.field(default_factory=dict)

    def set(self, value: float, **labels) -> None:
        self.values[label_key(labels)] = float(value)

    def get(self, **labels) -> float:
        return self.values.get(label_key(labels), 0.0)

    def snapshot(self) -> dict:
        return {"kind": self.kind, "help": self.help,
                "values": dict(self.values)}


@dataclasses.dataclass
class Histogram:
    name: str
    help: str = ""
    kind: str = "histogram"
    samples: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def observe(self, value: float, **labels) -> None:
        vals = self.samples.setdefault(label_key(labels), [])
        vals.append(float(value))
        if len(vals) > MAX_SAMPLES:
            del vals[: len(vals) - MAX_SAMPLES]

    def percentile(self, q: float, **labels) -> float:
        vals = sorted(self.samples.get(label_key(labels), []))
        return _percentile(vals, q)

    def snapshot(self) -> dict:
        out = {}
        for key, vals in self.samples.items():
            s = sorted(vals)
            out[key] = {
                "count": len(s),
                "sum": sum(s),
                "min": s[0] if s else 0.0,
                "max": s[-1] if s else 0.0,
                "p50": _percentile(s, 50),
                "p90": _percentile(s, 90),
                "p99": _percentile(s, 99),
            }
        return {"kind": self.kind, "help": self.help, "values": out}


class MetricsRegistry:
    """Get-or-create registry; kind conflicts are programming errors."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name=name, help=help)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {cls.__name__.lower()}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def reset(self) -> None:
        self._metrics = {}

    def snapshot(self) -> dict:
        return {
            "schema": METRICS_SCHEMA,
            "metrics": {name: self._metrics[name].snapshot()
                        for name in sorted(self._metrics)},
        }

    def render(self) -> str:
        """Human-readable text summary (one line per label set)."""
        lines = []
        for name in self.names():
            m = self._metrics[name]
            snap = m.snapshot()
            header = f"{name} [{m.kind}]"
            if m.help:
                header += f"  # {m.help}"
            lines.append(header)
            for key in sorted(snap["values"]):
                val = snap["values"][key]
                label = f"{{{key}}}" if key else ""
                if m.kind == "histogram":
                    lines.append(
                        f"  {label:<40} count={val['count']} "
                        f"sum={val['sum']:.6g} p50={val['p50']:.6g} "
                        f"p90={val['p90']:.6g} p99={val['p99']:.6g}")
                else:
                    lines.append(f"  {label:<40} {val:.6g}")
        return "\n".join(lines)


REGISTRY = MetricsRegistry()


def record_plan_cache(cache, registry: Optional[MetricsRegistry] = None,
                      name: str = "plan_cache") -> None:
    """Mirror a :class:`PlanCache`'s ``stats()`` into gauges."""
    reg = registry if registry is not None else REGISTRY
    stats = cache.stats()
    g = reg.gauge(name, help="PlanCache introspection (stats())")
    g.set(stats["hits"], field="hits")
    g.set(stats["misses"], field="misses")
    g.set(stats["hit_rate"], field="hit_rate")
    g.set(stats["interned"], field="interned")
    g.set(stats["n_builds"], field="n_builds")


def record_executor_cache(cache,
                          registry: Optional[MetricsRegistry] = None,
                          name: str = "executor_cache") -> None:
    """Mirror a :class:`StageExecutorCache`'s ``stats()`` into gauges —
    the executor tier of the pointer cache, next to the layout-tier
    ``plan_cache`` gauge.  ``traces`` counts executor builds (buffers
    and channels), ``calls`` trees reduced: a warm cache holds traces ==
    interned while calls grows."""
    reg = registry if registry is not None else REGISTRY
    stats = cache.stats()
    g = reg.gauge(name, help="StageExecutorCache introspection (stats())")
    g.set(stats["hits"], field="hits")
    g.set(stats["misses"], field="misses")
    g.set(stats["hit_rate"], field="hit_rate")
    g.set(stats["interned"], field="interned")
    g.set(stats["traces"], field="traces")
    g.set(stats["calls"], field="calls")


def record_schedule(sched, registry: Optional[MetricsRegistry] = None) -> None:
    """Count scheduled wire bytes by algorithm×codec for a resolution.

    Counts bytes *scheduled per resolve* (the host-side truth).  The
    port's aggregator resolves once per step (a plan-cache hit after the
    first), so these counters grow by one schedule per step.
    """
    reg = registry if registry is not None else REGISTRY
    c = reg.counter("schedule_wire_bytes",
                    help="wire bytes scheduled, by algorithm and codec")
    n = reg.counter("schedule_stages",
                    help="IR stages scheduled, by algorithm and codec")
    for _path, _bucket, st in sched.iter_stages():
        codec = getattr(st, "codec", "none") or "none"
        c.inc(st.wire_bytes, algorithm=st.algorithm, codec=codec)
        n.inc(1, algorithm=st.algorithm, codec=codec)
