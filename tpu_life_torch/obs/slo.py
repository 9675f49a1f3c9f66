"""Declarative SLOs with multi-window burn-rate alerting
(docs/OBSERVABILITY.md "SLOs and burn rates").

The time-series store (obs/timeseries.py) answers "what was p99 over the
last five minutes"; this module decides whether that answer is a page.
SLOs are **declarative specs** — a metric, an objective, and two
evaluation windows — loaded from a JSON/TOML file (``fleet --slo FILE``)
or the built-in defaults, and evaluated on the supervisor's monitor tick
with the SRE multi-window burn-rate rule: alert only when BOTH the fast
window (default 5 m — catches a cliff quickly) and the slow window
(default 1 h — suppresses blips the budget can absorb) burn the error
budget at or past the threshold.  A **breach** emits a typed
``slo.breach`` flight-recorder event and a trace instant carrying the
window, observed vs objective, the burn rate, and the top contributing
worker — so ``tpu-life doctor --slo CAPTURE`` can join a breach to its
cause (a kill, an OOM ladder walk, a watcher shed storm) the same way
the doctor joins migrations today.

Three spec kinds cover the stack's failure surface:

- ``quantile``: a latency bound — windowed p\\ *q* of a histogram family
  vs an objective in seconds (burn = observed / objective);
- ``ratio``: an error-budget fraction — a "bad" counter's windowed rate
  over a "total" counter's, vs an objective fraction;
- ``recovery``: a liveness bound — wall seconds from a worker's death to
  its replacement probing READY, fed by the supervisor's exit/ready
  hooks rather than the store (the victim can't report its own wake).

Spec files: JSON always works; TOML works on Python ≥ 3.11 (stdlib
``tomllib``) and falls back to a minimal flat-table subset parser on
older interpreters — no third-party dependency either way.

Pure stdlib, no jax/numpy (the obs package contract).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

from tpu_life_torch.obs import flight, trace
from tpu_life_torch.obs.timeseries import SeriesStore

#: SRE fast window: long enough for a real rate, short enough to page
#: before the budget is gone.
DEFAULT_FAST_WINDOW_S = 300.0

#: SRE slow window: the budget-absorption horizon.
DEFAULT_SLOW_WINDOW_S = 3600.0

#: Burn >= this in BOTH windows -> breach.  1.0 means "consuming budget
#: exactly at the objective" — the conservative default for a reference
#: stack; production alerting typically sets 2–14.
DEFAULT_BURN_THRESHOLD = 1.0

#: Seconds a breaching SLO stays quiet after firing (a breach is a
#: state, the event marks its edge; refiring every tick would flood the
#: flight ring that postmortems depend on).
REFIRE_SUPPRESS_S = 30.0

VALID_KINDS = ("quantile", "ratio", "recovery")


@dataclass(frozen=True)
class SloSpec:
    """One declarative objective.  ``metric``/``bad``/``total`` name
    series keys in the sampled snapshots (``obs.timeseries.series_key``
    form: bare family name, or ``name{label=value}``)."""

    name: str
    kind: str
    objective: float
    metric: str = ""          # quantile: histogram key; unused for ratio
    bad: str = ""             # ratio: numerator counter key
    total: str = ""           # ratio: denominator counter key
    q: float = 0.99           # quantile: which quantile
    fast_window_s: float = DEFAULT_FAST_WINDOW_S
    slow_window_s: float = DEFAULT_SLOW_WINDOW_S
    burn_threshold: float = DEFAULT_BURN_THRESHOLD

    def __post_init__(self):
        if self.kind not in VALID_KINDS:
            raise ValueError(
                f"slo {self.name!r}: kind must be one of {VALID_KINDS}, "
                f"got {self.kind!r}"
            )
        if self.objective <= 0:
            raise ValueError(
                f"slo {self.name!r}: objective must be > 0, got {self.objective}"
            )
        if self.kind == "quantile" and not self.metric:
            raise ValueError(f"slo {self.name!r}: quantile kind needs a metric")
        if self.kind == "ratio" and not (self.bad and self.total):
            raise ValueError(f"slo {self.name!r}: ratio kind needs bad and total")
        if not 0.0 <= self.q <= 1.0:
            raise ValueError(f"slo {self.name!r}: q must be in [0, 1], got {self.q}")
        if self.fast_window_s <= 0 or self.slow_window_s < self.fast_window_s:
            raise ValueError(
                f"slo {self.name!r}: need 0 < fast_window_s <= slow_window_s"
            )


def default_specs() -> list[SloSpec]:
    """The built-in objectives — one per tier of the serving story."""
    return [
        SloSpec(
            name="admission-p99",
            kind="quantile",
            metric="serve_queue_wait_seconds",
            q=0.99,
            objective=1.0,
        ),
        SloSpec(
            name="session-success",
            kind="ratio",
            bad='serve_sessions_finished_total{state=failed}',
            total="serve_sessions_finished_total",
            objective=0.01,
        ),
        SloSpec(
            name="frame-gap",
            kind="ratio",
            bad="stream_frame_gaps_total",
            total="stream_frames_total",
            objective=0.01,
        ),
        SloSpec(
            name="recovery-time",
            kind="recovery",
            objective=30.0,
        ),
    ]


# -- spec loading ---------------------------------------------------------
_NUM_FIELDS = ("objective", "q", "fast_window_s", "slow_window_s", "burn_threshold")
_STR_FIELDS = ("name", "kind", "metric", "bad", "total")


def _spec_from_dict(d: dict, where: str) -> SloSpec:
    unknown = set(d) - set(_NUM_FIELDS) - set(_STR_FIELDS)
    if unknown:
        raise ValueError(f"{where}: unknown slo field(s) {sorted(unknown)}")
    kw = {}
    for k in _STR_FIELDS:
        if k in d:
            kw[k] = str(d[k])
    for k in _NUM_FIELDS:
        if k in d:
            try:
                kw[k] = float(d[k])
            except (TypeError, ValueError):
                raise ValueError(f"{where}: field {k!r} must be a number") from None
    if "name" not in kw or "kind" not in kw or "objective" not in kw:
        raise ValueError(f"{where}: an slo needs name, kind, and objective")
    return SloSpec(**kw)


def _parse_toml_subset(text: str, where: str) -> dict:
    """The spec grammar's TOML subset, for interpreters without
    ``tomllib`` (< 3.11): ``[[slo]]`` array-of-tables whose entries are
    flat ``key = value`` scalars (strings, numbers, booleans).  Anything
    richer (nested tables, arrays, multi-line strings) raises with a
    pointer at the line — use JSON there."""
    slos: list[dict] = []
    current: dict | None = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip() if not raw.strip().startswith("#") else ""
        if not line:
            continue
        if line == "[[slo]]":
            current = {}
            slos.append(current)
            continue
        if line.startswith("["):
            raise ValueError(
                f"{where}:{lineno}: only [[slo]] tables are supported by the "
                f"built-in TOML subset reader (Python < 3.11); use JSON for "
                f"richer specs"
            )
        if "=" not in line or current is None:
            raise ValueError(f"{where}:{lineno}: expected key = value inside [[slo]]")
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip()
        if val.startswith('"') and val.endswith('"') and len(val) >= 2:
            current[key] = val[1:-1]
        elif val.startswith("'") and val.endswith("'") and len(val) >= 2:
            current[key] = val[1:-1]
        elif val in ("true", "false"):
            current[key] = val == "true"
        else:
            try:
                current[key] = float(val) if "." in val or "e" in val.lower() else int(val)
            except ValueError:
                raise ValueError(
                    f"{where}:{lineno}: unsupported value {val!r} (subset "
                    f"reader takes strings, numbers, booleans)"
                ) from None
    return {"slo": slos}


def load_specs(path: str) -> list[SloSpec]:
    """Load SLO specs from a ``.json`` or ``.toml`` file.

    JSON shape: ``{"slo": [{...}, ...]}`` (or a bare list).  TOML shape:
    one ``[[slo]]`` table per objective.  TOML parses with stdlib
    ``tomllib`` when available (Python ≥ 3.11), else the flat-subset
    reader — same grammar, no new dependency."""
    p = Path(path)
    text = p.read_text()
    where = str(p)
    if p.suffix.lower() == ".toml":
        try:
            import tomllib  # Python >= 3.11

            data = tomllib.loads(text)
        except ModuleNotFoundError:
            data = _parse_toml_subset(text, where)
        except Exception as e:  # tomllib.TOMLDecodeError
            raise ValueError(f"{where}: bad TOML: {e}") from e
    else:
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"{where}: bad JSON: {e}") from e
    if isinstance(data, list):
        raw = data
    elif isinstance(data, dict):
        raw = data.get("slo")
        if raw is None:
            raise ValueError(f'{where}: expected {{"slo": [...]}} or a bare list')
    else:
        raise ValueError(f"{where}: expected a list or table of slo specs")
    specs = [
        _spec_from_dict(d, f"{where} slo[{i}]") for i, d in enumerate(raw)
    ]
    names = [s.name for s in specs]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"{where}: duplicate slo name(s) {sorted(dupes)}")
    if not specs:
        raise ValueError(f"{where}: no slo specs defined")
    return specs


# -- the engine -----------------------------------------------------------
@dataclass
class _RecoveryState:
    exit_t: float
    generation: int
    breached: bool = False  # already fired for this outage


class SloEngine:
    """Evaluates specs against a :class:`SeriesStore` on every call to
    :meth:`evaluate` (the supervisor's monitor tick).  Windows clamp to
    the data actually retained — a fleet ten seconds old is judged on
    ten seconds, not absolved by an empty hour.  Not thread-safe on its
    own: the supervisor calls it from the tick thread only."""

    def __init__(
        self,
        specs: list[SloSpec],
        store: SeriesStore,
        *,
        clock=time.time,
    ):
        self.specs = list(specs)
        self.store = store
        self.clock = clock
        self._last_fire: dict[str, float] = {}
        self._outages: dict[str, _RecoveryState] = {}
        self._status: dict[str, dict] = {
            s.name: {"kind": s.kind, "objective": s.objective, "burn_fast": None,
                     "burn_slow": None, "observed": None, "breaching": False}
            for s in self.specs
        }
        self.breaches_fired = 0

    # -- recovery hooks (the supervisor's exit/ready path) ---------------
    def note_worker_exit(self, worker: str, generation: int, t: float | None = None) -> None:
        """A worker incarnation died un-drained; the recovery clock for
        its name starts now (an already-open outage keeps its original
        edge — a crash-looping respawn does not reset the clock)."""
        t = self.clock() if t is None else t
        if worker not in self._outages:
            self._outages[worker] = _RecoveryState(exit_t=t, generation=int(generation))

    def note_worker_ready(self, worker: str, generation: int, t: float | None = None) -> None:
        """A worker probed READY; if its name had an open outage, the
        recovery time is judged against every ``recovery`` spec."""
        state = self._outages.pop(worker, None)
        if state is None:
            return
        t = self.clock() if t is None else t
        took = max(0.0, t - state.exit_t)
        for spec in self.specs:
            if spec.kind != "recovery":
                continue
            st = self._status[spec.name]
            st["observed"] = took
            burn = took / spec.objective
            st["burn_fast"] = st["burn_slow"] = burn
            if took > spec.objective and not state.breached:
                self._fire(
                    spec, observed=took, burn=burn, window_s=took,
                    worker=worker, detail=f"recovered after {took:.3f}s",
                )
            st["breaching"] = took > spec.objective

    # -- evaluation -------------------------------------------------------
    def evaluate(self, now: float | None = None) -> list[dict]:
        """One burn-rate pass over every spec; returns the breaches
        fired THIS pass (already recorded to the flight ring)."""
        now = self.clock() if now is None else now
        fired = []
        for spec in self.specs:
            if spec.kind == "quantile":
                ev = self._eval_quantile(spec, now)
            elif spec.kind == "ratio":
                ev = self._eval_ratio(spec, now)
            else:
                ev = self._eval_recovery_open(spec, now)
            if ev is not None:
                fired.append(ev)
        return fired

    def _eval_quantile(self, spec: SloSpec, now: float) -> dict | None:
        fast = self.store.fleet_quantile(spec.metric, spec.q, spec.fast_window_s, now)
        slow = self.store.fleet_quantile(spec.metric, spec.q, spec.slow_window_s, now)
        st = self._status[spec.name]
        if fast is None or slow is None:
            st.update(burn_fast=None, burn_slow=None, observed=None, breaching=False)
            return None
        obs_fast, contrib = fast
        obs_slow, _ = slow
        burn_fast = obs_fast / spec.objective
        burn_slow = obs_slow / spec.objective
        st.update(burn_fast=burn_fast, burn_slow=burn_slow, observed=obs_fast)
        return self._judge(spec, burn_fast, burn_slow, obs_fast, contrib, now)

    def _eval_ratio(self, spec: SloSpec, now: float) -> dict | None:
        st = self._status[spec.name]

        def ratio_in(window_s):
            total = self.store.fleet_rate(spec.total, window_s, now)
            if total is None or total[0] <= 0:
                return None, None
            bad = self.store.fleet_rate(spec.bad, window_s, now)
            bad_rate, contrib = (0.0, {}) if bad is None else bad
            return bad_rate / total[0], contrib

        r_fast, contrib = ratio_in(spec.fast_window_s)
        r_slow, _ = ratio_in(spec.slow_window_s)
        if r_fast is None or r_slow is None:
            st.update(burn_fast=None, burn_slow=None, observed=None, breaching=False)
            return None
        burn_fast = r_fast / spec.objective
        burn_slow = r_slow / spec.objective
        st.update(burn_fast=burn_fast, burn_slow=burn_slow, observed=r_fast)
        return self._judge(spec, burn_fast, burn_slow, r_fast, contrib, now)

    def _eval_recovery_open(self, spec: SloSpec, now: float) -> dict | None:
        """An outage still open past the objective is a breach already —
        waiting for the ready edge would let a worker that never comes
        back never page."""
        st = self._status[spec.name]
        worst = None
        for worker, state in self._outages.items():
            down_for = now - state.exit_t
            if worst is None or down_for > worst[1]:
                worst = (worker, down_for, state)
        if worst is None:
            st["breaching"] = False
            return None
        worker, down_for, state = worst
        st["observed"] = down_for
        burn = down_for / spec.objective
        st["burn_fast"] = st["burn_slow"] = burn
        st["breaching"] = down_for > spec.objective
        if down_for > spec.objective and not state.breached:
            state.breached = True
            return self._fire(
                spec, observed=down_for, burn=burn, window_s=down_for,
                worker=worker, detail=f"down {down_for:.3f}s and counting",
            )
        return None

    def _judge(
        self, spec: SloSpec, burn_fast: float, burn_slow: float,
        observed: float, contrib: dict, now: float,
    ) -> dict | None:
        breaching = (
            burn_fast >= spec.burn_threshold and burn_slow >= spec.burn_threshold
        )
        self._status[spec.name]["breaching"] = breaching
        if not breaching:
            return None
        last = self._last_fire.get(spec.name)
        if last is not None and now - last < REFIRE_SUPPRESS_S:
            return None
        top = max(contrib, key=contrib.get) if contrib else None
        return self._fire(
            spec, observed=observed, burn=burn_fast,
            window_s=spec.fast_window_s, worker=top, now=now,
        )

    def _fire(
        self, spec: SloSpec, *, observed: float, burn: float, window_s: float,
        worker: str | None, detail: str | None = None, now: float | None = None,
    ) -> dict:
        now = self.clock() if now is None else now
        self._last_fire[spec.name] = now
        self.breaches_fired += 1
        ev = {
            "slo": spec.name,
            "slo_kind": spec.kind,
            "window_s": round(window_s, 3),
            "observed": round(observed, 6),
            "objective": spec.objective,
            "burn": round(burn, 3),
            "worker": worker,
        }
        if detail:
            ev["detail"] = detail
        flight.record("slo.breach", **ev)
        trace.instant("slo.breach", **ev)
        return ev

    def status(self) -> dict:
        """The burn gauges ``/healthz`` and ``tpu-life top`` show:
        per-slo kind, objective, fast/slow burn, observed, breaching."""
        return {name: dict(st) for name, st in self._status.items()}


# -- the doctor join ------------------------------------------------------
#: How far (seconds) before a breach the doctor looks for its cause.
CAUSE_HORIZON_S = 120.0

#: Event names that count as a plausible breach cause, best first.
_CAUSE_NAMES = (
    "flight.worker.exit",
    "flight.lease.expired",
    "flight.chaos.injection",
    "chaos.injection",
    "flight.engine.recovery",
    "flight.watcher.shed",
    "flight.oom.backoff",
)


def slo_report(doc: dict, *, horizon_s: float = CAUSE_HORIZON_S) -> dict:
    """Join every ``slo.breach`` instant in a merged capture to its
    plausible cause: the nearest preceding control-plane event (a kill,
    a lease expiry, a chaos injection, an engine recovery, a shed
    storm) within ``horizon_s`` — ``tpu-life doctor --slo CAPTURE``.

    Returns ``{"breaches": [...], "ok": bool}`` where each breach is a
    typed finding carrying the spec's numbers, the named worker, and a
    ``cause`` sub-record (or ``None`` when nothing in the horizon
    explains it)."""
    events = [
        ev for ev in doc.get("traceEvents", [])
        if isinstance(ev, dict) and "ts" in ev and isinstance(ev.get("args"), dict)
    ]
    events.sort(key=lambda e: float(e["ts"]))
    causes = [e for e in events if e.get("name") in _CAUSE_NAMES]
    breaches = []
    for ev in events:
        if ev.get("name") != "flight.slo.breach":
            continue
        args = ev["args"]
        ts = float(ev["ts"])
        cause = None
        for c in reversed(causes):
            c_ts = float(c["ts"])
            if c_ts > ts:
                continue
            if ts - c_ts > horizon_s * 1e6:
                break
            # prefer a cause naming the same worker when the breach
            # names one; otherwise the nearest cause wins
            c_args = c.get("args") or {}
            if args.get("worker") and c_args.get("worker") not in (
                None, args.get("worker")
            ):
                if cause is not None:
                    continue
            cause = {
                "kind": c.get("name"),
                "t_s": round(c_ts / 1e6, 6),
                "gap_s": round((ts - c_ts) / 1e6, 3),
                "args": {k: v for k, v in c_args.items() if k != "trace_id"},
            }
            if c_args.get("worker") == args.get("worker"):
                break  # exact worker match: stop looking
        breaches.append(
            {
                "kind": "slo_breach",
                "slo": args.get("slo"),
                "slo_kind": args.get("slo_kind"),
                "t_s": round(ts / 1e6, 6),
                "observed": args.get("observed"),
                "objective": args.get("objective"),
                "burn": args.get("burn"),
                "window_s": args.get("window_s"),
                "worker": args.get("worker"),
                "cause": cause,
            }
        )
    return {"breaches": breaches, "ok": not breaches}


def render_slo_report(report: dict) -> str:
    lines = []
    for b in report["breaches"]:
        head = (
            f"BREACH {b['slo']} ({b['slo_kind']}) at {b['t_s']:.3f}s: "
            f"observed {b['observed']} vs objective {b['objective']} "
            f"(burn {b['burn']}x over {b['window_s']}s"
        )
        head += f", worker {b['worker']})" if b.get("worker") else ")"
        lines.append(head)
        cause = b.get("cause")
        if cause:
            detail = " ".join(f"{k}={v}" for k, v in (cause["args"] or {}).items())
            lines.append(
                f"  cause: {cause['kind']} {cause['gap_s']}s earlier {detail}".rstrip()
            )
        else:
            lines.append("  cause: none found in the horizon")
    lines.append(
        f"verdict: {'OK' if report['ok'] else 'BREACHED'} "
        f"({len(report['breaches'])} breach(es))"
    )
    return "\n".join(lines)
