"""Session pinning: which worker (and which incarnation of it) owns a sid.

Worker gateways mint session ids independently (every worker starts at
``s000000``, and a RESTARTED worker starts at ``s000000`` again), so the
fleet id namespaces them by worker *and generation*: ``w1g2-s000042`` is
session ``s000042`` on the second incarnation of worker ``w1``.  Baking
the generation into the id is load-bearing: a pin into a dead generation
must resolve to a typed ``worker_lost``, never to the (identically
numbered) session the successor process mints — and a sid that merely
namespaced the worker name would be silently re-pinned onto the new
generation's session the moment the restarted worker reused it.

Pins are LRU-capped so a long-lived router cannot grow memory without
bound; an evicted pin degrades gracefully — the fleet sid encodes the
full pin, so resolution falls back to parsing it.  MIGRATED sids are the
exception (the known limit, fixed here): a re-pointed pin is the
ONLY record of where the session went — the sid string still encodes the
dead home, so falling back to parsing it would answer a spurious 410 for
a session that is alive and well on a survivor.  ``repin`` therefore
marks its entry *sticky*: eviction takes non-sticky pins first, and only
reaches sticky ones when the registry holds more migrated sessions than
``max_pins`` — the memory bound still wins, but a rescue is never
un-done by routine traffic churn.
"""

from __future__ import annotations

import re
import threading
from collections import OrderedDict
from dataclasses import dataclass

#: Default cap on live pins (sessions the router can route back to).
MAX_PINS = 100_000

_FLEET_SID = re.compile(r"(?P<worker>w\d+)g(?P<gen>\d+)-(?P<sid>.+)")


@dataclass(frozen=True)
class Pin:
    worker: str  # worker name, e.g. "w0"
    generation: int  # worker incarnation at submit time
    sid: str  # the worker's own session id


def fleet_sid(worker: str, generation: int, sid: str) -> str:
    return f"{worker}g{generation}-{sid}"


def parse_fleet_sid(fsid: str) -> Pin | None:
    """Recover the pin from the sid itself — the fallback when an LRU-
    evicted pin comes back (the encoding carries the whole pin)."""
    m = _FLEET_SID.fullmatch(fsid)
    if m is None:
        return None
    return Pin(
        worker=m.group("worker"),
        generation=int(m.group("gen")),
        sid=m.group("sid"),
    )


class SessionRegistry:
    """Thread-safe fleet-sid -> :class:`Pin` map with LRU eviction."""

    def __init__(self, max_pins: int = MAX_PINS):
        self.max_pins = max_pins
        self._pins: OrderedDict[str, Pin] = OrderedDict()
        self._sticky: set[str] = set()  # migrated sids: evicted LAST
        self._lock = threading.Lock()

    def _evict_locked(self) -> None:
        """LRU eviction, non-sticky pins first: a migrated sid's pin is
        the only record of its survivor home (the encoded prefix is the
        DEAD home), so routine churn must never evict it.  Only when the
        map is all-sticky and still over cap does the oldest sticky pin
        go — the absolute memory bound outranks even rescues."""
        while len(self._pins) > self.max_pins:
            victim = next(
                (k for k in self._pins if k not in self._sticky), None
            )
            if victim is None:
                victim = next(iter(self._pins))
                self._sticky.discard(victim)
            del self._pins[victim]

    def pin(self, worker: str, generation: int, sid: str) -> str:
        """Record the mapping; returns the fleet sid clients will use."""
        fsid = fleet_sid(worker, generation, sid)
        with self._lock:
            self._pins[fsid] = Pin(worker=worker, generation=generation, sid=sid)
            self._pins.move_to_end(fsid)
            self._evict_locked()
        return fsid

    def repin(self, fsid: str, worker: str, generation: int, sid: str) -> None:
        """Point an EXISTING fleet sid at a new home (session migration:
        the dead worker's session resumed on a survivor under the
        survivor's own sid).  The fleet sid string keeps encoding the
        ORIGINAL pin — that is what clients hold — and resolution's
        parse-the-sid fallback would therefore answer the dead home with
        a spurious 410, so a re-pointed pin is marked STICKY: ordinary
        pins evict around it and a rescued session stays reachable for
        its whole life (``forget`` — terminal retirement — releases it)."""
        with self._lock:
            self._pins[fsid] = Pin(worker=worker, generation=generation, sid=sid)
            self._pins.move_to_end(fsid)
            self._sticky.add(fsid)
            self._evict_locked()

    def resolve(self, fsid: str) -> Pin | None:
        """The pin for a fleet sid; falls back to prefix parsing when the
        pin was LRU-evicted.  None = not a fleet sid at all (404)."""
        with self._lock:
            pin = self._pins.get(fsid)
            if pin is not None:
                self._pins.move_to_end(fsid)
                return pin
        return parse_fleet_sid(fsid)

    def forget(self, fsid: str) -> None:
        with self._lock:
            self._pins.pop(fsid, None)
            self._sticky.discard(fsid)

    def __len__(self) -> int:
        with self._lock:
            return len(self._pins)
