"""Worker choice: weighted least queue depth, scraped from /metrics.

The routing signal is the same one the gateway's own load shedder uses —
the ``serve_queue_depth`` gauge the service updates every scheduling
round — read over HTTP from the worker's live ``/metrics`` endpoint.
Depth readings are cached with a short TTL: one scrape per worker per TTL
window bounds the metrics traffic no matter the submit rate, at the cost
of routing on a slightly stale signal (the router's refusal-retry and the
worker's own shed valve catch what staleness misses).

With per-worker device placement (docs/FLEET.md), workers are no longer
interchangeable: a 4-chip worker drains its queue ~4x faster than a
1-chip one, so raw least-depth would leave the big worker starved and the
small one swamped.  The balancer therefore routes by **capacity-
normalized depth** — ``depth / weight``, where the weight is the
worker's resolved device count — and breaks ties by **smooth weighted
round-robin** (the nginx algorithm: every worker accrues credit
proportional to its weight, the richest goes first and pays the total
back), so an IDLE heterogeneous fleet already spreads sessions in
capacity ratio (~1:4 for 1-chip vs 4-chip) instead of alternating 1:1.
Unweighted fleets degenerate to the old behavior: equal weights make the
normalization a no-op and the credit rotation a plain round-robin.
"""

from __future__ import annotations

import threading
import time

#: Depth assigned to a worker whose metrics could not be scraped — sorts
#: last, but stays a candidate (the submit-path retry skips it if dead).
UNKNOWN_DEPTH = float("inf")


def prom_value(text: str, name: str) -> float | None:
    """First sample value of an (unlabeled) metric in Prometheus text."""
    for line in text.splitlines():
        if line.startswith(name):
            rest = line[len(name) :]
            if rest.startswith(" "):
                try:
                    return float(rest.strip())
                except ValueError:
                    return None
    return None


class LeastDepthBalancer:
    """Order candidates by capacity-normalized cached queue depth, ties
    broken by smooth weighted round-robin.

    ``fetch`` takes a worker and returns its current queue depth (raising
    on failure); the router wires it to a ``/metrics`` scrape.  The cache
    is keyed by (worker name, generation) so a restarted worker never
    inherits its predecessor's reading.  ``weight`` takes a worker and
    returns its capacity weight (the router wires it to the resolved
    device count); None — or a weight that errors / is non-positive —
    means 1.0, the homogeneous pre-placement behavior.
    """

    def __init__(
        self, fetch, ttl_s: float = 0.5, *, clock=time.monotonic, weight=None
    ):
        self.fetch = fetch
        self.weight = weight
        self.ttl_s = ttl_s
        self.clock = clock
        self._cache: dict[tuple[str, int], tuple[float, float]] = {}
        #: smooth-WRR credit per worker NAME (not generation: capacity is
        #: a property of the slice, which survives restarts)
        self._credits: dict[str, float] = {}
        self._lock = threading.Lock()

    def _weight(self, worker) -> float:
        if self.weight is None:
            return 1.0
        try:
            w = float(self.weight(worker))
        except Exception:
            return 1.0
        return w if w > 0 else 1.0

    def depth(self, worker) -> float:
        """The worker's queue depth (cached within the TTL)."""
        return self.depths([worker])[worker.name]

    def depths(self, workers: list) -> dict:
        """name -> depth for all ``workers``, scraping STALE entries
        concurrently: a submit that lands on a cold cache must pay the
        slowest single scrape, not the sum of them (one wedged worker
        burning its timeout would otherwise stall every admission for a
        whole TTL window)."""
        now = self.clock()
        out: dict = {}
        stale: list = []
        with self._lock:
            for w in workers:
                hit = self._cache.get((w.name, w.generation))
                if hit is not None and now - hit[0] < self.ttl_s:
                    out[w.name] = hit[1]
                else:
                    stale.append(w)
        if stale:
            values: list = [None] * len(stale)

            def one(i: int, w) -> None:
                try:
                    values[i] = float(self.fetch(w))
                except Exception:
                    values[i] = UNKNOWN_DEPTH

            if len(stale) == 1:
                one(0, stale[0])
            else:
                threads = [
                    threading.Thread(target=one, args=(i, w), daemon=True)
                    for i, w in enumerate(stale)
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()  # bounded: fetch carries its own HTTP timeout
            with self._lock:
                for w, d in zip(stale, values):
                    key = (w.name, w.generation)
                    # drop readings from this worker's dead generations:
                    # restarts are unbounded over a router's lifetime, and
                    # a per-restart orphan entry would be a slow leak
                    for k in [
                        k for k in self._cache if k[0] == w.name and k != key
                    ]:
                        del self._cache[k]
                    self._cache[key] = (now, d)
                    out[w.name] = d
        return out

    def candidates(self, workers: list) -> list:
        """Workers ordered by weighted least depth (``depth / weight``);
        equal normalized depths follow the smooth-WRR credit order, so an
        idle heterogeneous fleet spreads in capacity ratio and an
        unweighted one round-robins as before."""
        if not workers:
            return []
        depths = self.depths(workers)
        weights = {w.name: self._weight(w) for w in workers}
        with self._lock:
            # credits belong to the CURRENT candidate set: a worker that
            # left the rotation (dead, draining) forfeits its balance
            # rather than leaking an entry per departed name
            live = {w.name for w in workers}
            for stale_name in [n for n in self._credits if n not in live]:
                del self._credits[stale_name]
            for w in workers:
                self._credits[w.name] = (
                    self._credits.get(w.name, 0.0) + weights[w.name]
                )
            keyed = [
                (
                    depths[w.name] / weights[w.name],
                    -self._credits[w.name],
                    i,
                    w,
                )
                for i, w in enumerate(workers)
            ]
            keyed.sort(key=lambda t: t[:3])
            # the CREDIT LEADER pays the whole round back (nginx smooth
            # WRR — at equal depths the leader IS the routed winner, so
            # over K idle picks each worker leads weight/total of them).
            # Charging the depth-selected winner instead would let
            # credits diverge without bound while a depth imbalance pins
            # routing to one worker, then burst-invert the spread once
            # depths re-equalize; paying the leader keeps every credit
            # inside one round's total regardless of depth weather.
            leader = max(workers, key=lambda w: self._credits[w.name])
            self._credits[leader.name] -= sum(weights.values())
        return [w for *_, w in keyed]

    def invalidate(self, worker) -> None:
        """Drop a worker's cached reading (e.g. right after routing to it,
        or after it refused — the next choice should re-scrape)."""
        with self._lock:
            self._cache.pop((worker.name, worker.generation), None)
