"""Runtime telemetry: span tracing, metrics, and timeline closure.

Counterpart of ``repro/telemetry``, with its names and schemas:

* :mod:`repro_torch.telemetry.trace` — a :class:`Tracer` producing
  nested ``Span(name, t0, t1, attrs)`` records keyed by the IR paths of
  the executed schedule (``bucket[i].stage[j].hop[k]``), exported as
  Chrome-trace / Perfetto ``trace_event`` JSON plus a schema-versioned
  ``repro/trace/v1`` record;
* :mod:`repro_torch.telemetry.metrics` — a process-local registry of
  counters / gauges / histograms (wire bytes by algorithm×codec, the
  plan and executor caches, step-time percentiles) with a JSON snapshot
  (``repro/metrics/v1``) and a text summary;
* :mod:`repro_torch.telemetry.closure` — the measured-vs-predicted
  closure: replays each distinct IR stage on a process group with host
  timers around device syncs, fits a calibration scalar per axis size,
  and holds the per-stage residuals to a declared band.

Telemetry is off by default (``REPRO_TRACE`` set to anything non-empty,
or :func:`configure`, turns it on).  Every hook in the execution path
guards on :func:`enabled` and records host-side metadata only: with
telemetry on or off a step computes the same bits and launches the
same kernels.

``closure`` imports :mod:`repro_torch.core`; it is not imported here,
so that core modules (reducers, plan cache, aggregator) can import
:mod:`repro_torch.telemetry` without a cycle.
"""
from . import metrics, trace
from .metrics import REGISTRY as METRICS
from .metrics import MetricsRegistry, record_executor_cache, \
    record_plan_cache
from .trace import (
    TRACE_SCHEMA,
    Span,
    TelemetryConfig,
    Tracer,
    configure,
    enabled,
    get_tracer,
)

__all__ = [
    "METRICS",
    "MetricsRegistry",
    "Span",
    "TRACE_SCHEMA",
    "TelemetryConfig",
    "Tracer",
    "configure",
    "enabled",
    "get_tracer",
    "metrics",
    "record_executor_cache",
    "record_plan_cache",
    "trace",
]
