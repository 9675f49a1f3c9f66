"""The flight recorder: a bounded ring of structured control-plane events.

Trace spans answer "where did the time go"; the flight recorder answers
"what happened to this session" — the small set of *decisions* a
postmortem needs (admissions, rejections, terminal outcomes, engine
recoveries, wedge verdicts, worker exits, leases, fences, migration
phases, chaos injections), kept in one process-wide bounded ring that is
always on.  Events are rare (per lifecycle transition, never per step or
per round), so recording is unconditionally cheap: one dict append under
a lock, oldest evicted past :data:`DEFAULT_MAX_EVENTS`.

Read-back paths:

- **servable live**: the gateway's ``GET /v1/debug/trace`` drain verb
  carries the flight ring next to the span ring, so a fleet supervisor's
  scrape (and ``tpu-life trace merge``) folds both into one timeline;
- **dumped on drain/wedge/crash**: a written trace file embeds the
  remaining flight events as ``flight.<kind>`` instant markers (the
  serve tier's close path), and a pump crash records its own event
  before the shutdown so the last capture names the cause.  A SIGKILL
  leaves whatever the last scrape already collected — which is why the
  supervisor scrapes continuously, like the chaos-counter scrape.

Every event is ``{"t": <epoch seconds>, "kind": <str>, ...attrs}``;
events about a session carry ``sid`` (and ``trace_id`` when the session
has one) so ``tpu-life doctor`` can join them into a journey.
"""

from __future__ import annotations

import threading
import time
from collections import deque

#: Flight-ring capacity.  Control-plane events are rare; 4096 covers
#: hours of a busy fleet while bounding a months-running process.
DEFAULT_MAX_EVENTS = 4096


class FlightRecorder:
    """One bounded event ring; the module-global :data:`RECORDER` is the
    process-wide instance every tier records into."""

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.max_events)
        self._dropped = 0
        self._recorded = 0

    def record(self, kind: str, **attrs) -> None:
        ev = {"t": time.time(), "kind": kind, **attrs}
        with self._lock:
            if len(self._events) == self.max_events:
                self._dropped += 1
            self._events.append(ev)
            self._recorded += 1

    def drain(self) -> list[dict]:
        """Take (and clear) the ring — the scrape path: each drain is an
        increment, so repeated scrapes never duplicate events."""
        with self._lock:
            taken = list(self._events)
            self._events.clear()
        return taken

    def snapshot(self) -> list[dict]:
        """A non-destructive copy (the written-file dump path)."""
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        return self._dropped

    @property
    def recorded(self) -> int:
        """Total events ever recorded in this process — a probe the way
        ``chaos.injection_count`` is one."""
        return self._recorded

    def reset(self) -> None:
        """Clear events and counters (tests)."""
        with self._lock:
            self._events.clear()
            self._dropped = 0
            self._recorded = 0


#: The process-wide recorder (one per process, like the chaos counters).
RECORDER = FlightRecorder()


def as_instant(ev: dict, *, pid: int, ts: float, tid: int = 0) -> dict:
    """One flight event rendered as a Chrome-trace ``flight.<kind>``
    instant marker — the ONE conversion both read-back paths use (the
    serve close-time dump and the capture merge differ only in how they
    anchor ``ts`` on their timeline, never in the event shape)."""
    attrs = {k: v for k, v in ev.items() if k not in ("t", "kind")}
    return {
        "name": f"flight.{ev.get('kind', 'event')}",
        "ph": "i",
        "s": "p",
        "pid": pid,
        "tid": tid,
        "ts": ts,
        "args": attrs,
    }


def record(kind: str, **attrs) -> None:
    """Record one structured event on the process-wide ring."""
    RECORDER.record(kind, **attrs)


def drain() -> list[dict]:
    return RECORDER.drain()


def snapshot() -> list[dict]:
    return RECORDER.snapshot()


def reset() -> None:
    RECORDER.reset()
