"""Admission control: token buckets and queue-depth load shedding.

Two independent valves in front of ``SimulationService.submit``:

- **Rate limiting** (:class:`KeyedBuckets`): a classic token bucket per
  API key — ``rate`` tokens/second refill up to ``burst`` capacity; a
  request costs one token.  A dry bucket yields the seconds until the
  next token, which becomes the 429's ``Retry-After``.  Per-key state is
  capped (LRU eviction) so an attacker rotating keys cannot grow memory.

- **Load shedding** (:class:`LoadShedder`): reject-before-enqueue when
  the serve queue-depth gauge crosses a high-water mark.  The gauge is
  sampled each scheduling round, so this is deliberately a *soft* valve
  measuring sustained pressure; the bounded admission queue
  (``QueueFull`` -> 503) is the hard backstop for the instants between
  rounds.  Shedding at the front door keeps the continuous-batching
  scheduler saturated-but-stable instead of building an unbounded latency
  backlog — the same shape as any inference stack's traffic layer.

Both are thread-safe (the gateway's handler threads race through them)
and clock-injectable (tests run on a fake clock, no sleeps).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

#: Default cap on distinct API keys holding bucket state.
MAX_KEYS = 1024


class TokenBucket:
    """One key's bucket: ``acquire()`` -> 0.0 (admitted) or seconds to wait.

    ``rate <= 0`` disables the bucket (every acquire admits) — the
    "unlimited" configuration, kept here so callers never branch.
    """

    def __init__(self, rate: float, burst: float, *, clock=time.monotonic):
        if rate > 0 and burst < 1:
            raise ValueError(f"burst must be >= 1 token, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self._tokens = self.burst
        self._at = clock()

    def acquire(self, n: float = 1.0) -> float:
        """Try to spend ``n`` tokens; 0.0 on success, else seconds until
        enough tokens will have refilled (the ``Retry-After`` value)."""
        if self.rate <= 0:
            return 0.0
        now = self.clock()
        self._tokens = min(self.burst, self._tokens + (now - self._at) * self.rate)
        self._at = now
        if self._tokens >= n:
            self._tokens -= n
            return 0.0
        return (n - self._tokens) / self.rate


class KeyedBuckets:
    """Per-API-key token buckets with bounded key cardinality.

    Keys are evicted least-recently-used past ``max_keys``; an evicted
    key that returns simply starts with a full bucket — strictly more
    permissive, never a denial-of-service on memory.
    """

    def __init__(
        self,
        rate: float,
        burst: float,
        *,
        clock=time.monotonic,
        max_keys: int = MAX_KEYS,
    ):
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self.max_keys = max_keys
        self._buckets: OrderedDict[str, TokenBucket] = OrderedDict()
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.rate > 0

    def acquire(self, key: str) -> float:
        """0.0 = admitted; > 0 = seconds the key must wait (429 path)."""
        if not self.enabled:
            return 0.0
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = TokenBucket(self.rate, self.burst, clock=self.clock)
                self._buckets[key] = bucket
                while len(self._buckets) > self.max_keys:
                    self._buckets.popitem(last=False)
            else:
                self._buckets.move_to_end(key)
            return bucket.acquire()


class LoadShedder:
    """Reject-before-enqueue when sustained queue depth crosses high water.

    ``depth`` is a callable returning the current queue-depth reading —
    the gateway wires it to the serve registry's ``serve_queue_depth``
    gauge, updated once per scheduling round.  ``high_water <= 0``
    disables shedding.
    """

    def __init__(self, depth, high_water: float, *, retry_after: float = 1.0):
        self.depth = depth
        self.high_water = float(high_water)
        self.retry_after = float(retry_after)

    @property
    def enabled(self) -> bool:
        return self.high_water > 0

    def check(self) -> tuple[float, float] | None:
        """None = admit; (depth, retry_after) = shed this request."""
        if not self.enabled:
            return None
        d = float(self.depth())
        if d >= self.high_water:
            return d, self.retry_after
        return None
