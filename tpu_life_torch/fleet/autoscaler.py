"""Demand-driven autoscaling (docs/FLEET.md "Autoscaling").

The supervisor already knows how to spawn, probe, drain, and fence
workers; the series store already knows what the fleet's load looks
like.  This module closes the loop: a control function that reads the
store's windows (queue depth, queue age, admission refusals, memory
pressure) plus the SLO engine's burn verdicts, and answers scale UP
(recruit a parked standby through the existing spawn/registration
machinery), scale DOWN (drain-and-release an idle worker — accepted
sessions finish, nothing is dropped), or HOLD.

Design rules, in order:

- **The decision is a pure function.**  :func:`decide` maps (signals,
  control state, policy, now) to a :class:`Decision` with no I/O — the
  unit tests drive it with synthetic signals and a fake clock, and every
  hysteresis/cooldown/flap property is provable without a process tree.
- **Flap resistance is structural, not tuned.**  Scale-up and scale-down
  trigger on DIFFERENT thresholds (``depth_high`` vs ``depth_low``, the
  classic hysteresis band), scale-down additionally requires the fleet
  to have LOOKED idle continuously for ``idle_grace_s``, and each
  direction carries its own cooldown — a burst that ends the moment we
  scaled up cannot bounce the fleet back down inside the grace window.
- **Every decision is evidence.**  Ups and downs (and the first hold of
  each distinct reason) land in the flight recorder as typed
  ``scale.up`` / ``scale.down`` / ``scale.hold`` events carrying the
  signal snapshot that justified them, so ``tpu-life doctor --scale``
  can replay the whole sequence from a trace capture and answer "why
  did we have 40 workers at 14:02".

Pure stdlib, no jax/numpy (the fleet-tier contract).  No imports from
:mod:`tpu_life_torch.fleet.supervisor` — the supervisor imports *us* (the
:class:`Autoscaler` takes it duck-typed), never the reverse.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from tpu_life_torch import chaos
from tpu_life_torch.obs import flight
from tpu_life_torch.runtime.metrics import log

#: Series keys whose windowed rates sum into the "demand is being turned
#: away" signal: the serve tier's hard refusals plus the gateway's sheds.
#: Per-tenant quota rejections are deliberately absent — a tenant at its
#: own declared ceiling is not fleet pressure.
DEFAULT_REJECT_KEYS = (
    "serve_admission_rejected_total{reason=queue_full}",
    "serve_admission_rejected_total{reason=overloaded}",
    "gateway_shed_total",
)


@dataclass(frozen=True)
class AutoscaleConfig:
    """The declarative scaling policy (``fleet --autoscale``)."""

    #: never drain below this many deployed workers
    min_workers: int = 1
    #: never recruit past this many deployed workers; None = bounded
    #: only by the standby pool
    max_workers: int | None = None
    #: mean queue depth per READY worker at/above which demand exceeds
    #: capacity — the scale-up edge of the hysteresis band
    depth_high: float = 4.0
    #: mean queue depth per READY worker at/below which the fleet is
    #: idle enough to shrink — the scale-down edge (must sit strictly
    #: below ``depth_high`` or the band is a flap generator)
    depth_low: float = 0.5
    #: oldest queued session older than this -> scale up even at modest
    #: depth (a stuck queue is demand the depth gauge understates)
    queue_age_high_s: float = 5.0
    #: fleet-wide refusal rate (sheds + queue_full, per second) that
    #: counts as demand being turned away -> scale up
    reject_rate_high: float = 0.5
    #: summed ``serve_estimated_bytes`` over summed budget at/above
    #: which the fleet is memory-bound -> scale up
    bytes_fraction_high: float = 0.85
    #: rate window for the refusal signal
    window_s: float = 30.0
    #: minimum seconds between consecutive scale-ups
    cooldown_up_s: float = 5.0
    #: minimum seconds between consecutive scale-downs (and between a
    #: scale-up and the next scale-down)
    cooldown_down_s: float = 30.0
    #: the fleet must look idle CONTINUOUSLY this long before any
    #: scale-down — the structural flap guard
    idle_grace_s: float = 10.0
    #: ignore a worker's gauges when its newest snapshot is older than
    #: this (a wedged worker's stale queue depth is not demand)
    gauge_max_age_s: float = 10.0
    #: a breaching SLO (fast+slow burn past threshold) counts as a
    #: scale-up signal when True
    scale_on_burn: bool = True
    #: the refusal-rate series keys (overridable for bespoke stacks)
    reject_keys: tuple[str, ...] = DEFAULT_REJECT_KEYS

    def __post_init__(self):
        if self.min_workers < 0:
            raise ValueError(
                f"min_workers must be >= 0, got {self.min_workers}"
            )
        if self.max_workers is not None and self.max_workers < max(
            1, self.min_workers
        ):
            raise ValueError(
                f"max_workers must be >= max(1, min_workers), "
                f"got {self.max_workers}"
            )
        if not self.depth_low < self.depth_high:
            raise ValueError(
                f"need depth_low < depth_high (the hysteresis band), "
                f"got {self.depth_low} vs {self.depth_high}"
            )
        for name in ("window_s", "idle_grace_s", "gauge_max_age_s"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")
        for name in ("cooldown_up_s", "cooldown_down_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")


@dataclass(frozen=True)
class Signals:
    """One evaluation's input: what the fleet looks like *right now*.
    Pure data — the unit tests build these by hand."""

    active: int  # deployed slots (ready + starting + restarting)
    standby: int  # parked, recruitable slots
    ready: int  # workers actually in the routing rotation
    depth: float  # fleet-summed serve_queue_depth
    queue_age_s: float  # max per-worker serve_queue_age_oldest_seconds
    reject_rate: float  # summed refusal rate over the window (per s)
    mem_fraction: float | None  # est bytes / budget, None when unknown
    breaching: bool  # any SLO breaching right now
    per_worker_depth: dict = field(default_factory=dict)

    @property
    def depth_per_ready(self) -> float:
        return self.depth / max(1, self.ready)


@dataclass
class ControlState:
    """The loop's memory between evaluations (mutable, clock-stamped
    with whatever clock the caller passes to :func:`decide`)."""

    last_up_at: float | None = None
    last_down_at: float | None = None
    #: when the fleet FIRST looked idle in the current idle stretch;
    #: None while any demand signal is up
    low_since: float | None = None


@dataclass(frozen=True)
class Decision:
    action: str  # "up" | "down" | "hold"
    reason: str
    worker: str | None = None
    signals: dict = field(default_factory=dict)


def _signal_doc(sig: Signals) -> dict:
    doc = {
        "active": sig.active,
        "standby": sig.standby,
        "ready": sig.ready,
        "depth": round(sig.depth, 3),
        "depth_per_ready": round(sig.depth_per_ready, 3),
        "queue_age_s": round(sig.queue_age_s, 3),
        "reject_rate": round(sig.reject_rate, 4),
        "breaching": sig.breaching,
    }
    if sig.mem_fraction is not None:
        doc["mem_fraction"] = round(sig.mem_fraction, 4)
    return doc


def decide(
    sig: Signals, state: ControlState, cfg: AutoscaleConfig, now: float
) -> Decision:
    """The pure control function: signals + memory + policy -> verdict.
    Mutates ``state`` (the idle timer) but touches nothing else."""
    doc = _signal_doc(sig)

    # which way is demand pushing?
    up_reason = None
    if sig.ready > 0 and sig.depth_per_ready >= cfg.depth_high:
        up_reason = "queue_depth"
    elif sig.queue_age_s >= cfg.queue_age_high_s:
        up_reason = "queue_age"
    elif sig.reject_rate >= cfg.reject_rate_high:
        up_reason = "rejections"
    elif (
        sig.mem_fraction is not None
        and sig.mem_fraction >= cfg.bytes_fraction_high
    ):
        up_reason = "memory_pressure"
    elif cfg.scale_on_burn and sig.breaching:
        up_reason = "slo_burn"
    elif sig.active < cfg.min_workers:
        up_reason = "below_min"

    idle = (
        up_reason is None
        and sig.depth_per_ready <= cfg.depth_low
        and sig.queue_age_s < cfg.queue_age_high_s
        and sig.reject_rate <= 0.0
        # an operator who disabled burn-driven scaling gets burn-blind
        # downs too — SLO state then neither grows nor pins the fleet
        and not (cfg.scale_on_burn and sig.breaching)
    )

    if up_reason is not None:
        state.low_since = None  # any demand restarts the idle clock
        if sig.standby <= 0:
            return Decision("hold", "no_standby", signals=doc)
        if (
            cfg.max_workers is not None
            and sig.active >= cfg.max_workers
            and up_reason != "below_min"
        ):
            return Decision("hold", "at_max", signals=doc)
        if (
            state.last_up_at is not None
            and now - state.last_up_at < cfg.cooldown_up_s
        ):
            return Decision("hold", "cooldown_up", signals=doc)
        return Decision("up", up_reason, signals=doc)

    if not idle:
        # in the hysteresis band: neither edge tripped — hold, and the
        # idle clock does NOT accumulate (idle must be continuous)
        state.low_since = None
        return Decision("hold", "steady", signals=doc)

    if sig.active <= cfg.min_workers:
        return Decision("hold", "at_min", signals=doc)
    if state.low_since is None:
        state.low_since = now
    if now - state.low_since < cfg.idle_grace_s:
        return Decision("hold", "settling", signals=doc)
    # a fresh scale-up also arms the down cooldown: a burst that ended
    # the moment we grew must not bounce straight back
    moves = [t for t in (state.last_down_at, state.last_up_at) if t is not None]
    last_move = max(moves) if moves else None
    if last_move is not None and now - last_move < cfg.cooldown_down_s:
        return Decision("hold", "cooldown_down", signals=doc)
    return Decision("down", "idle", signals=doc)


class Autoscaler:
    """The live loop: gathers :class:`Signals` from a supervisor's
    series store / SLO engine / membership view, runs :func:`decide`,
    executes the verdict through ``supervisor.recruit()`` /
    ``supervisor.release()``, and records every decision as flight
    evidence.  Driven from the supervisor's monitor tick at the series
    cadence; all its own state lives in :class:`ControlState`."""

    def __init__(self, cfg: AutoscaleConfig, supervisor):
        self.cfg = cfg
        self.sup = supervisor
        self.state = ControlState()
        self.decisions = 0
        #: the last hold reason recorded (holds only land in the flight
        #: ring on a reason EDGE — a steady fleet must not flood the
        #: ring the postmortem depends on)
        self._last_hold: str | None = None

    # -- signal gathering --------------------------------------------------
    def collect(self) -> Signals:
        store = self.sup.series_store
        active, standby = self.sup.scale_counts()
        ready = len(self.sup.ready_workers())
        depth = 0.0
        per_worker: dict = {}
        g = store.fleet_gauge(
            "serve_queue_depth", max_age_s=self.cfg.gauge_max_age_s
        )
        if g is not None:
            depth, per_worker = g
        age = 0.0
        g = store.fleet_gauge(
            "serve_queue_age_oldest_seconds",
            max_age_s=self.cfg.gauge_max_age_s,
        )
        if g is not None and g[1]:
            age = max(g[1].values())
        reject = 0.0
        for key in self.cfg.reject_keys:
            r = store.fleet_rate(key, self.cfg.window_s)
            if r is not None:
                reject += r[0]
        mem_fraction = None
        est = store.fleet_gauge(
            "serve_estimated_bytes", max_age_s=self.cfg.gauge_max_age_s
        )
        budget = store.fleet_gauge(
            "serve_memory_budget_bytes", max_age_s=self.cfg.gauge_max_age_s
        )
        if est is not None and budget is not None and budget[0] > 0:
            mem_fraction = est[0] / budget[0]
        breaching = any(
            st.get("breaching") for st in self.sup.slo_engine.status().values()
        )
        return Signals(
            active=active,
            standby=standby,
            ready=ready,
            depth=depth,
            queue_age_s=age,
            reject_rate=reject,
            mem_fraction=mem_fraction,
            breaching=breaching,
            per_worker_depth=per_worker,
        )

    # -- the loop body -----------------------------------------------------
    def evaluate(self, now: float) -> Decision:
        sig = self.collect()
        d = decide(sig, self.state, self.cfg, now)
        if d.action == "up":
            name = self.sup.recruit()
            if name is None:
                # the standby refused to launch (or chaos said it did):
                # hold, leave the cooldown unarmed so the next pass
                # retries immediately
                d = replace(d, action="hold", reason="recruit_failed")
            else:
                self.state.last_up_at = now
                d = replace(d, worker=name)
                log.info(
                    "fleet: scale up -> %s (%s, depth/worker %.1f)",
                    name,
                    d.reason,
                    sig.depth_per_ready,
                )
        elif d.action == "down":
            victim = self._pick_victim(sig)
            if victim is None or not self.sup.release(victim):
                d = replace(d, action="hold", reason="no_victim")
            else:
                self.state.last_down_at = now
                self.state.low_since = None
                d = replace(d, worker=victim)
                log.info("fleet: scale down -> releasing %s (idle)", victim)
        self._record(d)
        return d

    def _pick_victim(self, sig: Signals) -> str | None:
        """The idlest READY worker (lowest reported queue depth; a
        worker with no fresh gauge counts as idle).  The
        ``scale.release.race`` chaos point inverts the choice — the
        drain races live load, and graceful release must STILL lose no
        session (accepted work finishes before the worker exits)."""
        ready = self.sup.ready_workers()
        if not ready:
            return None
        d = chaos.decide("scale.release.race")
        if d is not None:
            chaos.record_fire("scale.release.race", "race")
            busiest = max(
                ready, key=lambda w: sig.per_worker_depth.get(w.name, 0.0)
            )
            return busiest.name
        idlest = min(
            ready, key=lambda w: sig.per_worker_depth.get(w.name, 0.0)
        )
        return idlest.name

    def _record(self, d: Decision) -> None:
        self.decisions += 1
        if d.action == "hold":
            if d.reason == self._last_hold:
                return  # steady state: the edge was already recorded
            self._last_hold = d.reason
        else:
            self._last_hold = None
        ev = dict(d.signals)
        ev["reason"] = d.reason
        if d.worker is not None:
            ev["worker"] = d.worker
        flight.record(f"scale.{d.action}", **ev)


# -- the doctor join ------------------------------------------------------
#: Flight-event names (as they appear in a merged trace capture) that
#: belong to the scaling story, in the order the report narrates them.
_SCALE_NAMES = (
    "flight.scale.up",
    "flight.scale.down",
    "flight.scale.hold",
    "flight.scale.recruit",
    "flight.scale.release",
)


def scale_report(doc: dict) -> dict:
    """Reconstruct the full scaling decision sequence from a merged
    trace capture (``tpu-life doctor --scale CAPTURE``): every typed
    ``scale.*`` flight event, time-ordered, each carrying the signal
    snapshot that justified it — the audit trail behind "why did we
    have 40 workers at 14:02"."""
    events = [
        ev
        for ev in doc.get("traceEvents", [])
        if isinstance(ev, dict)
        and ev.get("name") in _SCALE_NAMES
        and "ts" in ev
        and isinstance(ev.get("args"), dict)
    ]
    events.sort(key=lambda e: float(e["ts"]))
    decisions = []
    counts: dict[str, int] = {}
    for ev in events:
        action = ev["name"].rsplit(".", 1)[1]
        args = ev["args"]
        counts[action] = counts.get(action, 0) + 1
        decisions.append(
            {
                "t_s": round(float(ev["ts"]) / 1e6, 6),
                "action": action,
                "reason": args.get("reason"),
                "worker": args.get("worker"),
                "active": args.get("active"),
                "standby": args.get("standby"),
                "signals": {
                    k: v
                    for k, v in args.items()
                    if k not in ("reason", "worker", "trace_id")
                },
            }
        )
    return {"decisions": decisions, "counts": counts, "ok": True}


def render_scale_report(report: dict) -> str:
    lines = []
    for d in report["decisions"]:
        sig = d["signals"]
        parts = [f"{d['t_s']:.3f}s", d["action"].upper()]
        if d.get("worker"):
            parts.append(d["worker"])
        # recruit/release are action events with no reason — fall back
        # to their signal snapshot (generation, remote) for the audit line
        detail = d.get("reason") or ", ".join(
            f"{k}={v}" for k, v in sig.items() if not isinstance(v, (dict, list))
        ) or "?"
        if d.get("active") is not None:
            detail += (
                f" (active {d['active']}, standby {d['standby']}"
                f", depth/worker {sig.get('depth_per_ready', '?')})"
            )
        parts.append("— " + detail)
        lines.append(" ".join(parts))
    c = report["counts"]
    lines.append(
        f"verdict: {len(report['decisions'])} decision(s) — "
        f"{c.get('up', 0)} up, {c.get('down', 0)} down, "
        f"{c.get('hold', 0)} hold"
        if report["decisions"]
        else "no scale decisions in the capture (autoscaling off, or the "
        "fleet never left steady state)"
    )
    return "\n".join(lines)
