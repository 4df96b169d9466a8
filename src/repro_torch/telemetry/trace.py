"""Span tracing: nested host-timed spans keyed by ReduceSchedule IR paths.

Counterpart of ``repro/telemetry/trace.py``, with its names, its two
categories and its export formats.  A :class:`Span` is ``(name, cat,
t0, t1, attrs, children)``.  The categories keep the reference's names;
in the port they mean:

* ``cat="wall"`` — host wall-clock around work that ends with a device
  sync (``torch.cuda.synchronize`` on each CUDA device the result lives
  on; on the CPU there is nothing to wait for): ``train.step``
  (:class:`TimedFn`) and the closure's probes.  These are the spans
  whose durations measure the device's work.
* ``cat="trace"`` — the ``aggregate``, ``bucket[i]``, ``stage[j]`` and
  ``hop[k]`` spans of an eager aggregate.  No sync is added inside the
  aggregate, so on CUDA their durations are host *issue* time, not
  device time — the reference's tracing-time spans are not device time
  either.  On ``cuda_ipc``, where each hop waits on its peers' control
  messages, that host time is most of what the aggregate costs.  Their
  attributes (IR path, algorithm, codec, wire bytes) are exact: they
  come from the Stage objects the step executes.

Threads.  The overlap channel (``core/aggregator.py::OverlapRun``)
reduces buckets on a thread of its own, so unlike the reference's, this
tracer keeps the stack of open spans per thread (:meth:`Tracer.
current_path` reads the calling thread's) and guards its list of roots
with a lock.  A span opened on any thread but the main one carries
``attrs["thread"]``, that thread's name (``"overlap-channel"`` on the
channel), and :meth:`Tracer.chrome_trace` puts those on a track of
their own (``tid`` 2); main-thread spans keep ``tid`` 0 for ``wall``
and 1 for ``trace``.

Spans never touch the tensors, so with tracing on or off a step
computes the same bits and launches the same kernels.

The exporter writes one JSON file that is both Perfetto /
``chrome://tracing`` loadable (top-level ``traceEvents`` in the
``trace_event`` format) and schema-versioned (the span tree under the
``repro`` key, schema ``repro/trace/v1``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

TRACE_SCHEMA = "repro/trace/v1"

# Environment opt-in: any non-empty value enables the global tracer at
# import time.
ENV_VAR = "REPRO_TRACE"

CATEGORIES = ("wall", "trace")

# chrome_trace's track of the spans opened off the main thread.
THREAD_TID = 2


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Process-wide telemetry switch.  Off by default."""

    enabled: bool = False

    @staticmethod
    def from_env() -> "TelemetryConfig":
        return TelemetryConfig(enabled=bool(os.environ.get(ENV_VAR)))


@dataclasses.dataclass
class Span:
    name: str
    cat: str = "wall"
    t0: float = 0.0
    t1: float = 0.0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    children: List["Span"] = dataclasses.field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def set(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "cat": self.cat,
            "t0": self.t0,
            "t1": self.t1,
            "attrs": dict(self.attrs),
            "children": [c.to_json() for c in self.children],
        }

    @staticmethod
    def from_json(rec: dict) -> "Span":
        return Span(
            name=rec["name"],
            cat=rec.get("cat", "wall"),
            t0=float(rec["t0"]),
            t1=float(rec["t1"]),
            attrs=dict(rec.get("attrs", {})),
            children=[Span.from_json(c) for c in rec.get("children", [])],
        )


class _NullSpan:
    """Shared no-op context manager returned when tracing is disabled:
    ``tracer.span(...)`` costs one attribute check and allocates
    nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, key: str, value: Any) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        self._tracer._push(self.span)
        return self.span

    def __exit__(self, *exc) -> None:
        self._tracer._pop(self.span)


class Tracer:
    """Collects a forest of nested spans, from any number of threads:
    each thread nests its spans on a stack of its own, and a span
    opened with its thread's stack empty is a root."""

    def __init__(self, config: Optional[TelemetryConfig] = None):
        self.config = config if config is not None else TelemetryConfig()
        self.roots: List[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    @property
    def _stack(self) -> List[Span]:
        """The calling thread's open spans, outermost first."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, cat: str = "wall", **attrs):
        """Open a nested span; returns a context manager.

        When disabled this returns the shared no-op context manager
        without recording anything."""
        if not self.config.enabled:
            return _NULL_SPAN
        if cat not in CATEGORIES:
            raise ValueError(f"unknown span category {cat!r}; "
                             f"expected one of {CATEGORIES}")
        thread = threading.current_thread()
        if thread is not threading.main_thread():
            attrs["thread"] = thread.name
        return _SpanCtx(self, Span(name=name, cat=cat, attrs=attrs))

    def _push(self, span: Span) -> None:
        stack = self._stack
        span.t0 = time.perf_counter()
        if stack:
            stack[-1].children.append(span)
        else:
            with self._lock:
                self.roots.append(span)
        stack.append(span)

    def _pop(self, span: Span) -> None:
        span.t1 = time.perf_counter()
        stack = self._stack
        # Close any dangling descendants too (exception unwinds).
        while stack and stack[-1] is not span:
            inner = stack.pop()
            if not inner.t1:
                inner.t1 = span.t1
        if stack and stack[-1] is span:
            stack.pop()

    def current(self) -> "Span | None":
        """The calling thread's innermost open span, or None."""
        stack = self._stack
        return stack[-1] if stack else None

    def current_path(self) -> str:
        """IR path of the calling thread's innermost open span that
        carries one: ``execute_stages`` builds ``bucket[i].stage[j]``
        from the ``bucket[i]`` span the executor opened around it."""
        for span in reversed(self._stack):
            path = span.attrs.get("ir_path")
            if path:
                return str(path)
        return ""

    def clear(self) -> None:
        """Forget every span (call it with no span open on any
        thread)."""
        with self._lock:
            self.roots = []
            self._local = threading.local()

    # -- export ---------------------------------------------------------

    def iter_spans(self):
        """All spans, depth-first."""
        with self._lock:
            roots = list(self.roots)
        return walk(roots)

    def to_json(self) -> dict:
        with self._lock:
            roots = list(self.roots)
        return {
            "schema": TRACE_SCHEMA,
            "spans": [s.to_json() for s in roots],
        }

    def chrome_trace(self) -> dict:
        """Chrome ``trace_event`` JSON object format (Perfetto-loadable).

        Nested spans become stacked ``"ph": "X"`` complete events;
        timestamps are microseconds relative to the earliest span.
        ``tid`` 0 holds the main thread's ``wall`` spans, 1 its
        ``trace`` spans, 2 every span opened on another thread.  The
        full ``repro/trace/v1`` record rides along under the ``repro``
        key."""
        spans = list(self.iter_spans())
        t_base = min((s.t0 for s in spans), default=0.0)
        events = []
        for s in spans:
            tid = THREAD_TID if s.attrs.get("thread") \
                else (0 if s.cat == "wall" else 1)
            events.append({
                "name": s.name,
                "cat": s.cat,
                "ph": "X",
                "ts": (s.t0 - t_base) * 1e6,
                "dur": max(s.duration_s, 0.0) * 1e6,
                "pid": 0,
                "tid": tid,
                "args": {k: v for k, v in s.attrs.items()},
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "repro": self.to_json(),
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1, sort_keys=True)
            f.write("\n")


def walk(spans):
    """Every span under ``spans`` (roots included), depth-first."""
    stack = list(reversed(spans))
    while stack:
        s = stack.pop()
        yield s
        stack.extend(reversed(s.children))


def from_json(rec: dict) -> List[Span]:
    """Parse a ``repro/trace/v1`` record back into a span forest."""
    if rec.get("schema") != TRACE_SCHEMA:
        raise ValueError(f"not a {TRACE_SCHEMA} record: "
                         f"schema={rec.get('schema')!r}")
    return [Span.from_json(s) for s in rec.get("spans", [])]


def sync_devices(out) -> None:
    """Wait for every CUDA device a tensor of ``out`` (nested dicts,
    lists and tuples) lives on; tensors on the CPU need no wait.  The
    process's ``cuda_ipc`` channels sync first: their waits on the card
    have no timeout of their own, and a peer that never posts raises
    there, naming it."""
    devices = set()
    stack = [out]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            if node.device.type == "cuda":
                devices.add(node.device)
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    if devices:
        from ..core import dist as dist_mod
        dist_mod.sync_channels()
    for device in devices:
        torch.cuda.synchronize(device)


class TimedFn:
    """Wrap a callable with a ``wall`` span and a latency histogram: the
    span closes after :func:`sync_devices` on the result.  Attribute
    access goes to the wrapped function.  Only constructed when
    telemetry is enabled, so the disabled path never pays the
    indirection."""

    def __init__(self, fn: Callable, name: str, histogram: str = ""):
        self._fn = fn
        self._name = name
        self._histogram = histogram or f"{name}_s"

    def __call__(self, *args, **kwargs):
        from . import metrics

        tracer = get_tracer()
        with tracer.span(self._name, cat="wall") as sp:
            out = self._fn(*args, **kwargs)
            sync_devices(out)
            sp.set("synced", True)
        if isinstance(sp, Span):   # tracer may have been reconfigured off
            metrics.REGISTRY.histogram(
                self._histogram, help="host-timed latency (s)"
            ).observe(sp.t1 - sp.t0)
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)


def timed_call(fn: Callable, name: str, histogram: str = "") -> Callable:
    return TimedFn(fn, name, histogram)


# -- module-global tracer ----------------------------------------------

_GLOBAL = Tracer(TelemetryConfig.from_env())


def get_tracer() -> Tracer:
    return _GLOBAL


def configure(config: TelemetryConfig) -> Tracer:
    """Install a fresh global tracer with ``config``; returns it."""
    global _GLOBAL
    _GLOBAL = Tracer(config)
    return _GLOBAL


def enabled() -> bool:
    return _GLOBAL.config.enabled
