"""tpu_life_torch.obs: trace spans, the metrics registry, the flight
recorder, the time series and their read-back tools, tied to one
``run_id`` per invocation (a copy of ``tpu_life/obs``).

- :mod:`tpu_life_torch.obs.trace`: Chrome trace-event spans
  (``--trace-events FILE``) bracketing the driver's host phases and the
  service's rounds, with async queue-wait intervals and trace ids.
- :mod:`tpu_life_torch.obs.profiler`: ``profiler_span``, the Runners' and
  kernel wrappers' spans on a ``torch.profiler`` trace's clock.
- :mod:`tpu_life_torch.obs.registry`: ``Counter`` / ``Gauge`` /
  ``Histogram`` families, exported as records of the metrics JSONL sink.
- :mod:`tpu_life_torch.obs.flight`: the bounded ring of structured
  lifecycle events the service records.
- :mod:`tpu_life_torch.obs.timeseries`: the bounded ring of registry
  snapshots the service's pump samples.
- :mod:`tpu_life_torch.obs.stats`: the read-back toolchain behind
  ``stats``.
- :mod:`tpu_life_torch.obs.slo`: declarative SLO specs evaluated with
  multi-window burn rates on the fleet supervisor's tick.
- :mod:`tpu_life_torch.obs.console`: the ``top`` operator console and the
  refresh loop ``stats --watch`` shares.

:mod:`tpu_life_torch.obs.journey` (``trace merge``, ``doctor``) is imported
by its users.  This package imports neither torch nor numpy.
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
    activate,
    active_tracer,
    async_begin,
    async_end,
    complete,
    ensure_parent,
    instant,
    new_run_id,
    new_trace_id,
    now,
    reset_span_count,
    span,
    span_count,
    start_tracing,
    stop_tracing,
    tracing,
    valid_trace_id,
)
from tpu_life_torch.obs.profiler import profiler_span
from tpu_life_torch.obs import console, flight, slo, stats, timeseries

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
    "activate",
    "active_tracer",
    "console",
    "slo",
    "async_begin",
    "async_end",
    "complete",
    "ensure_parent",
    "flight",
    "instant",
    "new_run_id",
    "new_trace_id",
    "now",
    "profiler_span",
    "reset_span_count",
    "span",
    "span_count",
    "start_tracing",
    "stop_tracing",
    "stats",
    "timeseries",
    "tracing",
    "valid_trace_id",
]
