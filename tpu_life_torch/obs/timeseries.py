"""Time-series retention over the metrics registry (docs/OBSERVABILITY.md
"Time series").

Every signal the stack emits today is a point-in-time snapshot: the
registry answers "what is p99 *now*", never "what was p99 over the last
five minutes" — the question an SLO burn-rate alert (obs/slo.py), the
``tpu-life top`` console, and ROADMAP item 3's autoscaler all ask.  This
module closes the gap with a per-process bounded ring of periodic
registry snapshots and *pure* windowed queries over them:

- **Counters are delta-encoded** per snapshot (the cumulative value is
  kept privately by the sampler): the windowed rate is just the sum of
  the in-window deltas over the window.  Counters are monotone within a
  process, so deltas are never negative; a worker respawn starts a NEW
  ring (fresh ``seq``), and the supervisor's :class:`SeriesStore` keys
  retention by (worker, generation) — a counter reset reads as a new
  series, never a negative rate.
- **Histogram bucket vectors stay cumulative**: the distribution
  observed inside a window is the element-wise difference of two
  snapshots' vectors, so :func:`quantile_over_window` is a two-sample
  subtraction plus the registry's interpolation rule — a pure function
  of two snapshots, replayable from any capture of them.

The ring is scraped (non-destructively) through the worker verb
``GET /v1/debug/series?cursor=N``: the scraper passes the next sequence
number it wants, gets every retained snapshot at or past it plus
``next_cursor``, and ``dropped`` counts the snapshots that were evicted
before the cursor could catch up — same bounded, drop-counted,
survivor-safe discipline as the trace ring, except a cursor read
is repeatable (two scrapers, or a replay, see the same snapshots).

Cost discipline mirrors the tracer: a service with sampling disabled
holds no ring at all — the pump's retire tail does one ``is None``
check and nothing else — and the :func:`sample_count` probe counts real
snapshot builds so the disabled-overhead regression test can pin the
zero.

This module imports neither jax nor numpy (the obs package contract):
``tpu-life top`` and the capture read-back run login-node clean.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque
from pathlib import Path

#: Versions the snapshot/wire vocabulary (bump on shape changes).
SERIES_SCHEMA = 1

#: Default per-process snapshot retention.  At the default 1 s sampling
#: cadence this holds ~8.5 minutes of history — comfortably past the
#: 5 m fast SLO window; the slow window lives in the supervisor store.
DEFAULT_MAX_SNAPSHOTS = 512

#: Default per-(worker, generation) retention in a supervisor-side
#: store: one hour of 1 Hz snapshots, the slow-window horizon.
DEFAULT_STORE_SNAPSHOTS = 3600

#: Bound on distinct (worker, generation) series a store retains; the
#: oldest series is evicted first (a months-running control plane with a
#: flapping worker must not grow without bound).
DEFAULT_STORE_SERIES = 256


# -- the disabled-cost probe (the obs.span_count discipline) --------------
_PROBE = {"samples": 0}


def sample_count() -> int:
    """Real snapshot builds since the last reset — the disabled-overhead
    regression test asserts this stays at zero when sampling is off."""
    return _PROBE["samples"]


def reset_sample_count() -> None:
    _PROBE["samples"] = 0


# -- snapshot construction ------------------------------------------------
def series_key(name: str, labels: dict) -> str:
    """The flat key one label series gets in a snapshot:
    ``name`` bare, or ``name{k=v,...}`` in label-name order — small,
    stable, and joinable with the Prometheus exposition's series."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels.items())
    return name + "{" + inner + "}"


def snapshot_registry(registry, last_counters: dict | None = None, *, t=None) -> dict:
    """One snapshot of a :class:`~tpu_life_torch.obs.registry.MetricsRegistry`.

    ``last_counters`` is the sampler's private cumulative view from the
    previous snapshot; counters land in the snapshot as deltas against
    it (and the dict is updated in place).  Histogram vectors are
    emitted *cumulative* (counts per bucket from process start) next to
    their bucket bounds, so two snapshots subtract into a windowed
    distribution.  Pure data out: JSON-ready, no instrument references.
    """
    from tpu_life_torch.obs.registry import Counter, Gauge, Histogram

    snap = {
        "t": time.time() if t is None else float(t),
        "c": {},
        "g": {},
        "h": {},
    }
    for fam in registry.families():
        for labels, inst in fam.series():
            key = series_key(fam.name, labels)
            if isinstance(inst, Counter):
                cum = float(inst.value)
                prev = 0.0
                if last_counters is not None:
                    prev = last_counters.get(key, 0.0)
                    last_counters[key] = cum
                snap["c"][key] = cum - prev
            elif isinstance(inst, Gauge):
                snap["g"][key] = float(inst.value)
            elif isinstance(inst, Histogram):
                cum_counts = []
                acc = 0
                for c in inst.counts:
                    acc += c
                    cum_counts.append(acc)
                snap["h"][key] = {
                    "count": inst.count,
                    "sum": inst.sum,
                    "le": list(inst.buckets),
                    # cumulative counts, one per finite bound plus +Inf
                    "buckets": cum_counts,
                }
    return snap


class SeriesRing:
    """The per-process bounded snapshot ring behind ``/v1/debug/series``.

    Appends assign monotone sequence numbers; past ``max_snapshots`` the
    oldest snapshot is evicted (flight-recorder semantics) and the loss
    is visible to any cursor that had not read it yet.  Reads are
    cursor-based and non-destructive — the scrape discipline is
    *incremental* like the trace ring's drain, but repeatable, so a
    second scraper (or a replay of the first) never races the first.
    """

    def __init__(self, max_snapshots: int = DEFAULT_MAX_SNAPSHOTS):
        if max_snapshots < 1:
            raise ValueError(f"max_snapshots must be >= 1, got {max_snapshots}")
        self.max_snapshots = max_snapshots
        self._snaps: deque = deque()
        self._next_seq = 0
        self._last_counters: dict[str, float] = {}
        self._lock = threading.Lock()

    def sample(self, registry, *, t=None) -> dict:
        """Snapshot ``registry`` and append it to the ring."""
        snap = snapshot_registry(registry, self._last_counters, t=t)
        with self._lock:
            snap["seq"] = self._next_seq
            self._next_seq += 1
            self._snaps.append(snap)
            if len(self._snaps) > self.max_snapshots:
                self._snaps.popleft()
        _PROBE["samples"] += 1
        return snap

    def read(self, cursor: int = 0) -> dict:
        """Snapshots with ``seq >= cursor``, plus the scrape bookkeeping:
        ``next_cursor`` (pass it back next time) and ``dropped`` — how
        many snapshots past the cursor were evicted before this read
        (0 when the scraper is keeping up)."""
        if cursor < 0:
            raise ValueError(f"cursor must be >= 0, got {cursor}")
        with self._lock:
            oldest = self._snaps[0]["seq"] if self._snaps else self._next_seq
            dropped = max(0, min(oldest, self._next_seq) - cursor)
            out = [s for s in self._snaps if s["seq"] >= cursor]
            return {
                "schema": SERIES_SCHEMA,
                "snapshots": out,
                "next_cursor": self._next_seq,
                "dropped": dropped,
            }

    def snapshots(self) -> list[dict]:
        with self._lock:
            return list(self._snaps)

    def __len__(self) -> int:
        with self._lock:
            return len(self._snaps)


# -- pure windowed queries ------------------------------------------------
def window_snapshots(snapshots: list[dict], window_s: float, now: float | None = None) -> list[dict]:
    """The snapshots inside ``[now - window_s, now]`` (time-ordered in =
    time-ordered out).  ``now`` defaults to the newest snapshot's stamp,
    so a replay over a capture needs no live clock."""
    if not snapshots:
        return []
    if now is None:
        now = max(s["t"] for s in snapshots)
    lo = now - window_s
    return [s for s in snapshots if lo <= s["t"] <= now]


def rate(
    snapshots: list[dict],
    key: str,
    window_s: float,
    now: float | None = None,
) -> float | None:
    """Windowed counter rate: the sum of in-window deltas over the
    window.  ``None`` when the window holds no snapshot carrying the
    key (no data is not a zero rate).  Deltas are non-negative by
    construction — a reset is a different (worker, generation) series,
    never a negative contribution here."""
    win = window_snapshots(snapshots, window_s, now)
    hits = [s["c"][key] for s in win if key in s.get("c", {})]
    if not hits:
        return None
    return sum(hits) / window_s if window_s > 0 else None


def hist_window(older: dict | None, newer: dict, key: str) -> dict | None:
    """The distribution observed between two snapshots: element-wise
    difference of their cumulative bucket vectors.

    ``older=None`` (or an older snapshot without the key) reads as
    "since series start" — the newer vector alone.  A negative
    difference means the two snapshots straddle a counter reset (two
    generations mixed into one series by a caller): the window falls
    back to the newer snapshot alone — the new series — instead of ever
    producing negative mass.  Returns ``None`` when the newer snapshot
    does not carry the key."""
    h1 = newer.get("h", {}).get(key)
    if h1 is None:
        return None
    h0 = older.get("h", {}).get(key) if older is not None else None
    if h0 is None or h0.get("le") != h1.get("le"):
        return {"le": list(h1["le"]), "buckets": list(h1["buckets"]),
                "count": h1["count"], "sum": h1["sum"]}
    diff = [b1 - b0 for b0, b1 in zip(h0["buckets"], h1["buckets"])]
    if any(d < 0 for d in diff) or h1["count"] < h0["count"]:
        # counter reset inside the pair: the newer snapshot IS the new
        # series — read it alone, never report negative mass
        return {"le": list(h1["le"]), "buckets": list(h1["buckets"]),
                "count": h1["count"], "sum": h1["sum"]}
    return {
        "le": list(h1["le"]),
        "buckets": diff,
        "count": h1["count"] - h0["count"],
        "sum": h1["sum"] - h0["sum"],
    }


def quantile_from_cumulative(le: list, buckets: list, q: float) -> float | None:
    """The registry's interpolation rule over a cumulative bucket vector
    (``le`` = finite upper bounds; ``buckets`` has one extra +Inf slot).

    Without per-window min/max there is nothing to clamp against, so the
    estimate interpolates inside the target bucket; a rank landing in
    the +Inf tail returns the highest finite bound — the documented
    honest *lower* bound for the tail (there is no finite upper one)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = buckets[-1] if buckets else 0
    if not total:
        return None
    rank = q * total
    lo = 0.0
    for i, bound in enumerate(le):
        cum = buckets[i]
        if cum >= rank:
            prev = buckets[i - 1] if i else 0
            in_bucket = cum - prev
            if not in_bucket:
                return bound
            return lo + (bound - lo) * (rank - prev) / in_bucket
        lo = bound
    return le[-1] if le else None


def quantile_over_window(
    older: dict | None, newer: dict, key: str, q: float
) -> float | None:
    """Windowed quantile as a pure function of two snapshots: subtract
    the cumulative vectors (:func:`hist_window`), interpolate the rank.
    ``None`` on an empty window (no observations between the samples)."""
    win = hist_window(older, newer, key)
    if win is None or not win["count"]:
        return None
    return quantile_from_cumulative(win["le"], win["buckets"], q)


def merge_hist_windows(windows: list[dict]) -> dict | None:
    """Sum windowed distributions across series (a fleet's workers):
    element-wise bucket addition.  Series with mismatched bounds are
    skipped (never silently misbinned); ``None`` when nothing merges."""
    windows = [w for w in windows if w is not None]
    if not windows:
        return None
    le = windows[0]["le"]
    merged = None
    for w in windows:
        if w["le"] != le:
            continue
        if merged is None:
            merged = {"le": list(le), "buckets": list(w["buckets"]),
                      "count": w["count"], "sum": w["sum"]}
        else:
            merged["buckets"] = [
                a + b for a, b in zip(merged["buckets"], w["buckets"])
            ]
            merged["count"] += w["count"]
            merged["sum"] += w["sum"]
    return merged


# -- the supervisor-side store --------------------------------------------
class SeriesStore:
    """Fleet-wide snapshot retention keyed by (worker, generation).

    Each scrape of a worker's ring lands here (and, with ``--trace-dir``,
    in the ``<name>.series.jsonl`` capture file).  Keying by generation
    is what makes counter continuity hold across a respawn: the dead
    incarnation's deltas stay under its own key, the successor starts a
    fresh series, and a windowed query sums *deltas* across series —
    no subtraction ever crosses a generation boundary."""

    def __init__(
        self,
        max_snapshots: int = DEFAULT_STORE_SNAPSHOTS,
        max_series: int = DEFAULT_STORE_SERIES,
    ):
        self.max_snapshots = max_snapshots
        self.max_series = max_series
        self._series: OrderedDict[tuple[str, int], deque] = OrderedDict()
        #: scrape-reported eviction losses per (worker, generation) —
        #: snapshots the ring dropped before the scraper caught up
        self.dropped: dict[tuple[str, int], int] = {}
        self._lock = threading.Lock()

    def extend(
        self, worker: str, generation: int, snapshots: list[dict], dropped: int = 0
    ) -> None:
        key = (worker, int(generation))
        with self._lock:
            dq = self._series.get(key)
            if dq is None:
                dq = self._series[key] = deque(maxlen=self.max_snapshots)
                while len(self._series) > self.max_series:
                    old, _ = self._series.popitem(last=False)
                    self.dropped.pop(old, None)
            seen = dq[-1]["seq"] if dq and "seq" in dq[-1] else -1
            for s in snapshots:
                # a re-scraped overlap (repeatable cursor reads) folds
                # away on seq: only genuinely new snapshots append
                if s.get("seq", seen + 1) > seen:
                    dq.append(s)
                    seen = s.get("seq", seen + 1)
            if dropped:
                self.dropped[key] = self.dropped.get(key, 0) + int(dropped)

    def series_keys(self) -> list[tuple[str, int]]:
        with self._lock:
            return list(self._series)

    def get(self, worker: str, generation: int) -> list[dict]:
        with self._lock:
            return list(self._series.get((worker, int(generation)), ()))

    def all_series(self, worker: str | None = None) -> dict[tuple[str, int], list[dict]]:
        with self._lock:
            return {
                k: list(v)
                for k, v in self._series.items()
                if worker is None or k[0] == worker
            }

    # -- fleet-wide windowed queries (pure over the retained snapshots) --
    def fleet_rate(
        self, key: str, window_s: float, now: float | None = None
    ) -> tuple[float, dict[str, float]] | None:
        """Summed windowed rate across every retained series, plus the
        per-worker contributions (the breach's "top contributing label").
        ``None`` when no series carries the key in the window."""
        per_worker: dict[str, float] = {}
        any_hit = False
        for (worker, _gen), snaps in self.all_series().items():
            r = rate(snaps, key, window_s, now)
            if r is None:
                continue
            any_hit = True
            per_worker[worker] = per_worker.get(worker, 0.0) + r
        if not any_hit:
            return None
        return sum(per_worker.values()), per_worker

    def fleet_gauge(
        self, key: str, max_age_s: float | None = None, now: float | None = None
    ) -> tuple[float, dict[str, float]] | None:
        """Summed *latest* gauge value across the fleet, plus per-worker
        contributions — the instantaneous-load read the autoscaler keys
        on (queue depth, estimated bytes).  Only each worker's newest
        generation counts (a dead incarnation's final gauge must not
        double-count against its successor), and with ``max_age_s`` set,
        series whose newest snapshot is older than that are skipped —
        a wedged worker's stale gauge is not demand.  ``None`` when no
        live series carries the key."""
        newest_gen: dict[str, int] = {}
        for worker, gen in self.series_keys():
            if gen >= newest_gen.get(worker, gen):
                newest_gen[worker] = gen
        per_worker: dict[str, float] = {}
        any_hit = False
        t_ref = now
        if t_ref is None and max_age_s is not None:
            stamps = [
                snaps[-1]["t"]
                for snaps in self.all_series().values()
                if snaps
            ]
            t_ref = max(stamps) if stamps else None
        for (worker, gen), snaps in self.all_series().items():
            if gen != newest_gen.get(worker) or not snaps:
                continue
            last = snaps[-1]
            if (
                max_age_s is not None
                and t_ref is not None
                and last["t"] < t_ref - max_age_s
            ):
                continue
            v = last.get("g", {}).get(key)
            if v is None:
                continue
            any_hit = True
            per_worker[worker] = per_worker.get(worker, 0.0) + float(v)
        if not any_hit:
            return None
        return sum(per_worker.values()), per_worker

    def fleet_quantile(
        self, key: str, q: float, window_s: float, now: float | None = None
    ) -> tuple[float, dict[str, int]] | None:
        """Fleet-wide windowed quantile: per series, subtract the newest
        in-window snapshot from the one just before the window (series
        start when none), merge the distributions, interpolate.  Also
        returns per-worker in-window observation counts (the top
        contributor).  ``None`` on an empty fleet window."""
        windows = []
        counts: dict[str, int] = {}
        for (worker, _gen), snaps in self.all_series().items():
            if not snaps:
                continue
            t_now = now if now is not None else max(s["t"] for s in snaps)
            lo = t_now - window_s
            inside = [s for s in snaps if lo <= s["t"] <= t_now]
            if not inside:
                continue
            before = [s for s in snaps if s["t"] < lo]
            older = before[-1] if before else None
            win = hist_window(older, inside[-1], key)
            if win is None or not win["count"]:
                continue
            windows.append(win)
            counts[worker] = counts.get(worker, 0) + win["count"]
        merged = merge_hist_windows(windows)
        if merged is None or not merged["count"]:
            return None
        return quantile_from_cumulative(merged["le"], merged["buckets"], q), counts


# -- capture read-back ----------------------------------------------------
def load_series_capture(path: str) -> SeriesStore:
    """Rebuild a :class:`SeriesStore` from a fleet's ``*.series.jsonl``
    capture files (a directory, or one file) — the replay path behind
    the acceptance drill: every windowed query over the store is a pure
    function of these scraped snapshots.  A torn final line (killed
    collector) is tolerated, the stats-loader rule."""
    p = Path(path)
    files = sorted(p.glob("*.series.jsonl")) if p.is_dir() else [p]
    if p.is_dir() and not files:
        raise FileNotFoundError(f"no *.series.jsonl capture files under {path}")
    store = SeriesStore()
    for f in files:
        lines = f.read_text().splitlines()
        for lineno, line in enumerate(lines, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                if lineno == len(lines):
                    break  # torn tail: a killed writer, not a bad capture
                raise ValueError(f"{f}:{lineno}: bad series record: {e}") from e
            store.extend(
                str(rec.get("worker", "?")),
                int(rec.get("generation", 0)),
                rec.get("snapshots") or [],
                dropped=int(rec.get("dropped", 0)),
            )
    return store
