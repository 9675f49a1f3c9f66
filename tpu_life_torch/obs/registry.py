"""A labeled metrics registry: Counter / Gauge / Histogram families (a
copy of ``tpu_life/obs/registry.py``).

The serving layer needs latency *distributions* (queue wait, completion)
and the driver needs compile counts and chunk-duration spread — plain
per-chunk JSONL lines can't answer "what is p95 queue wait".  This is the
minimal production shape: metric *families* keyed by name, label *series*
under each family, and two exporters — records in the existing metrics
JSONL vocabulary (so one sink file carries both the per-chunk stream and
the end-of-run aggregates) and a Prometheus text-exposition snapshot.

Cardinality is bounded by construction: each family accepts at most
``max_series`` distinct label combinations; the first combination past the
cap is collapsed into a single ``__overflow__`` series (with one warning),
so a misbehaving label value — a raw session id, an unbucketed shape —
can degrade a metric's resolution but never grow memory without bound.
Label values must come from small closed sets by convention: backend
names, rule names, CompileKey buckets (``rule:HxW:backend``).

Histograms are fixed-bucket (Prometheus style): observation cost is one
bisect, memory is ``len(buckets)+1`` ints, and quantiles are estimated by
linear interpolation inside the bucket containing the target rank,
clamped to the observed min/max (exact at the extremes, documented
approximation in between — the standard trade for bounded memory).
"""

from __future__ import annotations

import logging
from bisect import bisect_left

log = logging.getLogger("tpu_life_torch")

#: Default histogram buckets (seconds): Prometheus' latency defaults plus a
#: 1 ms floor bucket — serve chunk rounds on CPU tests land well under 5 ms.
DEFAULT_BUCKETS = (
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
)

#: Default per-family series cap (distinct label combinations).
MAX_SERIES = 64

OVERFLOW = "__overflow__"


class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        self.value += n

    def state(self) -> dict:
        return {"value": self.value}


class Gauge:
    """A value that goes up and down (queue depth, occupancy)."""

    kind = "gauge"

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def state(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket distribution with quantile estimation.

    ``buckets`` are inclusive upper bounds (ascending); one implicit
    ``+Inf`` bucket catches the tail.  ``quantile(q)`` walks the
    cumulative counts to the bucket holding rank ``q * count`` and
    interpolates linearly inside it; results are clamped to the observed
    ``[min, max]``, so ``quantile(0.0) == min`` and ``quantile(1.0) == max``
    exactly.  Empty histograms return ``None``.
    """

    kind = "histogram"

    __slots__ = ("buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets: tuple = DEFAULT_BUCKETS):
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"buckets must be ascending and non-empty, got {buckets}")
        self.buckets = b
        self.counts = [0] * (len(b) + 1)  # last = +Inf
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> float | None:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        assert self.min is not None and self.max is not None
        rank = q * self.count
        cum = 0
        lo = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                lo = self.buckets[i] if i < len(self.buckets) else lo
                continue
            if cum + c >= rank:
                if i >= len(self.buckets):
                    # +Inf bucket: no finite upper bound — the observed max
                    # is the only honest estimate for the tail
                    return self.max
                hi = self.buckets[i]
                est = lo + (hi - lo) * (rank - cum) / c
                return min(max(est, self.min), self.max)
            cum += c
            lo = self.buckets[i] if i < len(self.buckets) else lo
        return self.max

    def state(self) -> dict:
        rec = {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            # per-bucket (non-cumulative) counts keyed by upper bound; the
            # stats toolchain can re-derive quantiles from these
            "buckets": {
                **{repr(b): c for b, c in zip(self.buckets, self.counts)},
                "+Inf": self.counts[-1],
            },
        }
        for name, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
            rec[name] = self.quantile(q)
        return rec


class Family:
    """One named metric family: label series of a single instrument kind."""

    def __init__(
        self,
        name: str,
        cls,
        help: str = "",
        labelnames: tuple = (),
        max_series: int = MAX_SERIES,
        **instrument_kwargs,
    ):
        self.name = name
        self.cls = cls
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = max_series
        self._kwargs = instrument_kwargs
        self._series: dict[tuple, object] = {}
        self._warned_overflow = False

    def labels(self, **labelvalues):
        """The instrument for one label combination (created on first use;
        past the cardinality cap, the shared ``__overflow__`` series)."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(labelvalues)}"
            )
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        inst = self._series.get(key)
        if inst is None:
            if len(self._series) >= self.max_series and key != self._overflow_key():
                if not self._warned_overflow:
                    self._warned_overflow = True
                    log.warning(
                        "metric %s exceeded its %d-series label cardinality "
                        "cap; further label combinations collapse into %s",
                        self.name,
                        self.max_series,
                        OVERFLOW,
                    )
                key = self._overflow_key()
                inst = self._series.get(key)
                if inst is not None:
                    return inst
            inst = self._series[key] = self.cls(**self._kwargs)
        return inst

    def _overflow_key(self) -> tuple:
        return tuple(OVERFLOW for _ in self.labelnames)

    # unlabeled convenience: a family declared with no labelnames behaves
    # like its single instrument
    def _default(self):
        return self.labels()

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def quantile(self, q: float):
        return self._default().quantile(q)

    @property
    def value(self):
        return self._default().value

    def series(self) -> list[tuple[dict, object]]:
        """(labels dict, instrument) per series, insertion-ordered."""
        return [
            (dict(zip(self.labelnames, key)), inst)
            for key, inst in self._series.items()
        ]


class MetricsRegistry:
    """Registered metric families plus the two exporters.

    Registration is idempotent: asking for an existing name with the same
    kind and labelnames returns the existing family (so layers can declare
    their instruments independently); a kind or label mismatch raises.
    """

    def __init__(self):
        self._families: dict[str, Family] = {}

    def _register(self, name, cls, help, labels, max_series, **kwargs) -> Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.cls is not cls or fam.labelnames != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as {fam.cls.kind} "
                    f"with labels {fam.labelnames}"
                )
            return fam
        fam = self._families[name] = Family(
            name, cls, help=help, labelnames=tuple(labels),
            max_series=max_series, **kwargs,
        )
        return fam

    def counter(
        self, name: str, help: str = "", labels: tuple = (),
        max_series: int = MAX_SERIES,
    ) -> Family:
        return self._register(name, Counter, help, labels, max_series)

    def gauge(
        self, name: str, help: str = "", labels: tuple = (),
        max_series: int = MAX_SERIES,
    ) -> Family:
        return self._register(name, Gauge, help, labels, max_series)

    def histogram(
        self, name: str, help: str = "", labels: tuple = (),
        buckets: tuple = DEFAULT_BUCKETS, max_series: int = MAX_SERIES,
    ) -> Family:
        return self._register(
            name, Histogram, help, labels, max_series, buckets=buckets
        )

    def families(self) -> list[Family]:
        return list(self._families.values())

    # -- exporters --------------------------------------------------------
    def snapshot(self, run_id: str | None = None) -> list[dict]:
        """One record per series in the metrics-JSONL vocabulary
        (``kind: "metric"``) — appended to the same sink file as the
        per-chunk stream, read back by ``tpu-life stats``."""
        out = []
        for fam in self._families.values():
            for labels, inst in fam.series():
                rec = {
                    "kind": "metric",
                    "metric": fam.name,
                    "type": inst.kind,
                    "labels": labels,
                    **inst.state(),
                }
                if run_id is not None:
                    rec["run_id"] = run_id
                out.append(rec)
        return out

    def prom_text(self) -> str:
        """Prometheus text exposition (one snapshot, not a live endpoint —
        write it to ``--prom-file`` for node-exporter-style file scraping)."""
        lines: list[str] = []
        for fam in self._families.values():
            series = fam.series()
            if not series:
                continue
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.cls.kind}")
            for labels, inst in series:
                if isinstance(inst, Histogram):
                    cum = 0
                    for b, c in zip(inst.buckets, inst.counts):
                        cum += c
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_prom_labels({**labels, 'le': _fmt(b)})} {cum}"
                        )
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_prom_labels({**labels, 'le': '+Inf'})} {inst.count}"
                    )
                    lines.append(
                        f"{fam.name}_sum{_prom_labels(labels)} {_fmt(inst.sum)}"
                    )
                    lines.append(
                        f"{fam.name}_count{_prom_labels(labels)} {inst.count}"
                    )
                else:
                    lines.append(
                        f"{fam.name}{_prom_labels(labels)} {_fmt(inst.value)}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    # integral values print without the trailing .0 (matches prom tooling)
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in labels.items())
    return "{" + inner + "}"
