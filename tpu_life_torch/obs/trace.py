"""Run-correlated trace spans in Chrome trace-event JSON (a trimmed copy
of ``tpu_life/obs/trace.py``).

A :class:`Tracer` collects Chrome trace events (the format Perfetto and
``chrome://tracing`` load directly) and writes them as one JSON object
``{"traceEvents": [...], "otherData": {"run_id": ...}}``, the schema
(``TELEMETRY_SCHEMA``) the JAX package writes.  The driver brackets each
host phase of a run with a span: config resolution, the backend build,
staging, each host-sync chunk, snapshot writes, recovery rewinds, the
gather and the output write.

- **Disabled tracing is free.**  :func:`span` returns a shared
  ``nullcontext`` when no tracer is active: no event, no clock read, no
  probe increment.  Spans bracket host phases only; the kernels never see
  a per-step Python callback either way.
- **Run identity.**  Every tracer carries a ``run_id``, also stamped into
  the metrics JSONL records, so the artifacts of one run join on one key.
- **Probe counter.**  :func:`span_count` counts span entries; the
  disabled-telemetry tests assert it stays at zero.

Events (timestamps in microseconds since the tracer started): ``ph:
"B"/"E"`` nested duration spans, ``ph: "X"`` complete events measured
after the fact (the per-chunk records) and ``ph: "i"`` instant markers.
The JAX module's async spans, trace ids and ring draining serve its
serving tier and wait for that port.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager, nullcontext
from pathlib import Path

#: Version of the telemetry record vocabulary (trace event args, metrics
#: JSONL fields); equal to the JAX package's, whose files these match.
TELEMETRY_SCHEMA = 1

#: Span-ring capacity (events): past it the OLDEST events are evicted and
#: ``Tracer.dropped`` counts the loss.
DEFAULT_MAX_EVENTS = 65536


def new_run_id() -> str:
    """A fresh correlation id: 12 hex chars, unique per invocation."""
    return uuid.uuid4().hex[:12]


def ensure_parent(path) -> None:
    """Create a file's parent directories (the shared exporter prelude)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)


# the span probe: a mutable holder so tests hold a live view through the
# module, not a stale int import
_PROBE = {"spans": 0}


def span_count() -> int:
    """Spans actually entered by an active tracer in this process — the
    disabled-telemetry overhead probe (zero when tracing never enabled)."""
    return _PROBE["spans"]


def reset_span_count() -> None:
    _PROBE["spans"] = 0


class Tracer:
    """Collects Chrome trace events in a bounded ring; :meth:`write`
    emits the file.

    In-memory buffering keeps the hot path to one deque append; the
    driver calls :meth:`write` from a ``finally`` so a failed run still
    leaves its partial trace on disk.  The ring is bounded
    (``max_events``): past it the OLDEST events are evicted and
    ``dropped`` counts the evictions.
    """

    def __init__(
        self,
        path: str,
        run_id: str | None = None,
        *,
        max_events: int = DEFAULT_MAX_EVENTS,
    ):
        self.path = str(path)
        self.run_id = run_id or new_run_id()
        self._t0 = time.perf_counter()
        #: wall clock at tracer start — the cross-process anchor: an
        #: event's epoch time is ``wall_t0 + ts/1e6``, which is how the
        #: fleet merge aligns per-worker rings on one timeline
        self.wall_t0 = time.time()
        self._pid = os.getpid()
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = int(max_events)
        self._events: deque = deque()
        # emitters (pump/verb threads) and drain (the HTTP scrape
        # handler) run on different threads: the ring is locked so a
        # span racing a scrape lands on exactly one side of the drain,
        # never on an abandoned buffer.  Events are host-phase-level —
        # one uncontended acquire each is noise (the flight ring pays
        # the same).
        self._buf_lock = threading.Lock()
        self.dropped = 0

    # -- clocks -----------------------------------------------------------
    def now(self) -> float:
        """Seconds since tracer start (the clock every event lives on)."""
        return time.perf_counter() - self._t0

    def _ts(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, ev: dict) -> None:
        with self._buf_lock:
            self._events.append(ev)
            # ring semantics: evict oldest past the cap (one popleft per
            # append once saturated — O(1), no reallocation)
            while len(self._events) > self.max_events:
                self._events.popleft()
                self.dropped += 1

    # -- event emitters ---------------------------------------------------
    @contextmanager
    def span(self, name: str, **attrs):
        """A nested B/E duration span around the enclosed block."""
        _PROBE["spans"] += 1
        tid = threading.get_ident()
        self._emit(
            {
                "name": name,
                "ph": "B",
                "ts": self._ts(),
                "pid": self._pid,
                "tid": tid,
                "args": attrs,
            }
        )
        try:
            yield self
        finally:
            self._emit(
                {
                    "name": name,
                    "ph": "E",
                    "ts": self._ts(),
                    "pid": self._pid,
                    "tid": tid,
                }
            )

    def complete(self, name: str, start_s: float, end_s: float, **attrs) -> None:
        """A complete (ph ``X``) event for an interval measured after the
        fact — ``start_s``/``end_s`` are on this tracer's :meth:`now` clock."""
        self._emit(
            {
                "name": name,
                "ph": "X",
                "ts": start_s * 1e6,
                "dur": max(0.0, end_s - start_s) * 1e6,
                "pid": self._pid,
                "tid": threading.get_ident(),
                "args": attrs,
            }
        )

    def instant(self, name: str, **attrs) -> None:
        self._emit(
            {
                "name": name,
                "ph": "i",
                "s": "p",  # process-scoped marker
                "ts": self._ts(),
                "pid": self._pid,
                "tid": threading.get_ident(),
                "args": attrs,
            }
        )

    # -- output -----------------------------------------------------------
    def write(self) -> str:
        """Write the Chrome-trace JSON object; returns the path written."""
        ensure_parent(self.path)
        with self._buf_lock:
            # snapshot under the ring lock: a handler-thread emit (or a
            # racing scrape) during the copy would otherwise mutate the
            # deque mid-iteration and abort the write
            events = list(self._events)
            dropped = self.dropped
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "run_id": self.run_id,
                "telemetry_schema": TELEMETRY_SCHEMA,
                # the cross-process anchors (docs/OBSERVABILITY.md
                # "Distributed tracing"): the epoch second ts=0 maps to,
                # and how many ring evictions this buffer suffered —
                # additive fields, so schema-1 consumers are unaffected
                "wall_t0": self.wall_t0,
                "pid": self._pid,
                "dropped": dropped,
            },
        }
        with open(self.path, "w") as f:
            json.dump(doc, f)
        return self.path


# -- the module-level switchboard ------------------------------------------
# one active tracer per process (the driver owns one invocation); disabled
# == None == every entry point below is a no-op

_NULL = nullcontext()
_ACTIVE: Tracer | None = None


def active_tracer() -> Tracer | None:
    return _ACTIVE


def start_tracing(path: str, run_id: str | None = None) -> Tracer:
    """Activate a tracer writing to ``path``; returns it (pass back to
    :func:`stop_tracing`).  Starting over an already-active tracer replaces
    it — the previous owner's ``stop_tracing(tracer)`` still writes its
    file, it just stops receiving new events."""
    global _ACTIVE
    _ACTIVE = Tracer(path, run_id)
    return _ACTIVE


def stop_tracing(tracer: Tracer | None = None) -> str | None:
    """Write and deactivate (``tracer=None`` stops whichever is active).
    Returns the path written, or None when there was nothing to stop."""
    global _ACTIVE
    t = tracer if tracer is not None else _ACTIVE
    if t is None:
        return None
    if _ACTIVE is t:
        _ACTIVE = None
    return t.write()


def span(name: str, **attrs):
    """A span on the active tracer, or a free shared ``nullcontext``."""
    t = _ACTIVE
    if t is None:
        return _NULL
    return t.span(name, **attrs)


def complete(name: str, start_s: float, end_s: float, **attrs) -> None:
    t = _ACTIVE
    if t is not None:
        t.complete(name, start_s, end_s, **attrs)


def instant(name: str, **attrs) -> None:
    t = _ACTIVE
    if t is not None:
        t.instant(name, **attrs)


def now() -> float:
    """The active tracer's clock (seconds), or 0.0 when tracing is off —
    callers that measure intervals for :func:`complete` events can call it
    unconditionally."""
    t = _ACTIVE
    return t.now() if t is not None else 0.0
