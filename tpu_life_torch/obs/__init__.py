"""tpu_life_torch.obs: trace spans and the metrics registry, tied to one
``run_id`` per invocation (the part of ``tpu_life/obs`` the run driver
uses).

- :mod:`tpu_life_torch.obs.trace`: Chrome trace-event spans
  (``--trace-events FILE``) bracketing the driver's host phases.
- :mod:`tpu_life_torch.obs.registry`: ``Counter`` / ``Gauge`` /
  ``Histogram`` families, exported as records of the metrics JSONL sink.

The JAX package's console, flight recorder, SLOs, stats, time series and
journeys belong to its serving tier and wait for that port.  This package
imports neither torch nor numpy.
"""

from tpu_life_torch.obs.registry import (
    DEFAULT_BUCKETS,
    Counter,
    Family,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from tpu_life_torch.obs.trace import (
    DEFAULT_MAX_EVENTS,
    TELEMETRY_SCHEMA,
    Tracer,
    active_tracer,
    complete,
    ensure_parent,
    instant,
    new_run_id,
    now,
    reset_span_count,
    span,
    span_count,
    start_tracing,
    stop_tracing,
)

__all__ = [
    "TELEMETRY_SCHEMA",
    "DEFAULT_BUCKETS",
    "DEFAULT_MAX_EVENTS",
    "Counter",
    "Family",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Tracer",
    "active_tracer",
    "complete",
    "ensure_parent",
    "instant",
    "new_run_id",
    "now",
    "reset_span_count",
    "span",
    "span_count",
    "start_tracing",
    "stop_tracing",
]
