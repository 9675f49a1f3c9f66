"""tpu_life_torch.chaos — deterministic fault injection (a copy of the
seams of ``tpu_life/chaos/__init__.py``).

The **injection registry**: a process-wide, seeded :class:`ChaosPlan` of
named injection points threaded through the real seams — spill
writes/reads, snapshot bytes, engine chunk dispatch/collect/OOM/wedge.
Every decision is a **pure function of (seed, point, nth call at that
point)** — the same Threefry-2x32 counter discipline as
``tpu_life_torch.mc.prng`` — so a chaos run's fault schedule replays
exactly from its seed.  Disarmed (the default), every seam is a no-op:
one module-global ``None`` check, no draws, no counting.  The drills
that arm a plan against a real fleet are :mod:`tpu_life_torch.chaos.drill`
and :mod:`tpu_life_torch.chaos.crosshost` (``python -m tpu_life_torch
chaos``).

Arming: programmatic (``chaos.arm(plan)`` / the :func:`armed_plan`
context manager) or via ``TPU_LIFE_CHAOS`` — a JSON plan spec in the
environment, picked up once at CLI entry (``maybe_arm_from_env``), which
is how the drill arms the gateway *worker subprocesses* it spawns: the
supervisor's spawn copies the parent environment, so one exported spec
arms every process of the fleet, each drawing its own per-process
deterministic schedule.

Plan spec (JSON)::

    {"seed": 42,
     "points": {"spill.write":  {"rate": 1.0, "mode": "enospc", "times": 2},
                "worker.crash": {"rate": 0.02, "mode": "exit"}}}

``rate`` is the per-call fire probability (the Threefry draw decides),
``mode`` selects the failure shape at that seam, optional ``times``
bounds total fires (the first ``times`` firing draws fire, later ones
pass — a deterministic way to guarantee "exactly a couple of faults"),
and mode-specific knobs (``seconds`` for sleeps/skews) ride alongside.
Unknown points and modes are typed :class:`ChaosError`\\ s at plan
construction, never silent no-ops.
"""

from __future__ import annotations

import contextlib
import errno
import hashlib
import json
import os
import threading
import zlib
from dataclasses import dataclass

import numpy as _np

from tpu_life_torch.utils.threefry import key_halves, threefry2x32, threshold_u32
from tpu_life_torch.obs import flight as _flight
from tpu_life_torch.obs import trace as _trace

#: Environment variable carrying a JSON plan spec; read once per process
#: at CLI entry (``maybe_arm_from_env``), inherited by spawned workers.
ENV_VAR = "TPU_LIFE_CHAOS"

#: The injection-point table: name -> legal modes (docs/CHAOS.md has the
#: seam and failure-shape of each).  A closed set — arming an unknown
#: point is a typed error, so a typo'd drill never silently tests nothing.
POINTS: dict[str, tuple[str, ...]] = {
    # serve spill store (durability)
    "spill.write": ("enospc", "oserror"),  # raises inside SpillStore.save
    "spill.read": ("oserror",),  # raises inside read_spill_sessions
    "snapshot.corrupt": ("bitflip", "truncate"),  # mangles published bytes
    # serve engines (per-key chunk faults)
    "engine.dispatch": ("fault",),  # recovery.InjectedFault at dispatch
    "engine.collect": ("fault",),  # recovery.InjectedFault at collect
    # serve-tier resource governor (docs/SERVING.md "Resource governance")
    "engine.oom": ("oom",),  # RESOURCE_EXHAUSTED InjectedFault at dispatch
    "engine.wedge": ("sleep",),  # collect/settle stalls `seconds` (watchdog drill)
    # gateway worker lifecycle
    "worker.crash": ("exit",),  # os._exit from the pump loop
    "worker.hang": ("sleep",),  # pump loop stalls `seconds`
    "worker.unready": ("refuse",),  # /readyz answers 500
    "worker.start_delay": ("sleep",),  # startup line delayed `seconds`
    # fleet router transport
    "router.submit.reset": ("reset",),  # pre-send reset (refusal path)
    "router.poll.reset": ("mid_exchange", "mid_body"),  # ambiguity paths
    # live-session streaming (docs/STREAMING.md)
    "stream.reset": ("reset",),  # worker stream drops MID-FRAME (torn line)
    "watch.slow_reader": ("sleep",),  # a fan-out watcher stalls `seconds`
    # fleet supervisor / migrator
    "probe.skew": ("skew",),  # monitor clock reads skew by up to `seconds`
    "migrate.die": ("die",),  # the migration thread is never started
    # demand-driven autoscaling (docs/FLEET.md "Autoscaling")
    "scale.recruit.fail": ("refuse",),  # recruit() launches nobody (standby
    # failed to start) — the loop holds and retries next evaluation
    "scale.release.race": ("race",),  # scale-down victim selection grabs a
    # BUSY worker: the drain races live load; graceful release must
    # still lose no accepted session
    # cross-host control plane (docs/FLEET.md "Cross-host topology")
    "lease.heartbeat.drop": ("drop",),  # registrar heartbeat never sent
    "lease.register.reset": ("reset",),  # registration POST reset pre-send
    # remote spill store (HTTP backend)
    "spill.remote.timeout": ("timeout",),  # request times out client-side
    "spill.remote.torn_body": ("torn",),  # response body truncated on read
    # seeded per-peer connectivity mask: drawn PER PAIR via decide_pair,
    # so one armed point partitions some links and spares others — the
    # asymmetric-partition drill (router->worker, worker->control-plane,
    # worker->spill-store all consult it with their own pair labels)
    "net.partition": ("drop",),
}


class ChaosError(ValueError):
    """A malformed chaos plan (unknown point, unknown mode, bad rate) —
    typed so a drill config error fails loudly at construction."""


@dataclass(frozen=True)
class Fault:
    """One armed injection point's failure shape."""

    point: str
    mode: str
    rate: float = 1.0
    times: int | None = None  # bound on total fires (None = unlimited)
    seconds: float = 1.0  # sleep/skew magnitude for the timing modes

    def __post_init__(self):
        modes = POINTS.get(self.point)
        if modes is None:
            raise ChaosError(
                f"unknown chaos point {self.point!r} "
                f"(known: {', '.join(sorted(POINTS))})"
            )
        if self.mode not in modes:
            raise ChaosError(
                f"point {self.point!r} has no mode {self.mode!r} "
                f"(legal: {', '.join(modes)})"
            )
        if not 0.0 <= self.rate <= 1.0:
            raise ChaosError(f"rate must be in [0, 1], got {self.rate}")
        if self.times is not None and self.times < 0:
            raise ChaosError(f"times must be >= 0, got {self.times}")
        if self.seconds < 0:
            raise ChaosError(f"seconds must be >= 0, got {self.seconds}")


@dataclass
class Decision:
    """One fired injection: the fault plus its deterministic draw word
    (callers use ``draw`` for sub-choices — e.g. which bit to flip — so
    even the fault's *content* replays from the seed)."""

    fault: Fault
    draw: int  # the second Threefry output word, uint32


class ChaosPlan:
    """A seeded fault plan: per-point decisions as pure functions.

    The decision for the nth call at point ``p`` under seed ``S`` is::

        u0, u1 = threefry2x32(key=key_halves(S), counter=(crc32(p), n))
        fires  = u0 < threshold(rate)   (and fire_count < times)

    Per-point call counters are process-local, so every process in a
    fleet (router front, each worker) draws its own deterministic
    schedule from the one exported spec.  ``Decision.draw`` hands the
    second output word to the seam for deterministic sub-choices.
    """

    def __init__(self, seed: int, points: dict[str, dict] | None = None):
        self.seed = int(seed)
        self._k0, self._k1 = key_halves(self.seed)
        self.faults: dict[str, Fault] = {}
        for name, spec in (points or {}).items():
            if not isinstance(spec, dict):
                raise ChaosError(
                    f"point {name!r} spec must be an object, got {spec!r}"
                )
            unknown = set(spec) - {"rate", "mode", "times", "seconds"}
            if unknown:
                raise ChaosError(
                    f"point {name!r} spec has unknown keys {sorted(unknown)}"
                )
            if "mode" not in spec:
                raise ChaosError(f"point {name!r} spec needs a mode")
            self.faults[name] = Fault(
                point=name,
                mode=str(spec["mode"]),
                rate=float(spec.get("rate", 1.0)),
                times=None if spec.get("times") is None else int(spec["times"]),
                seconds=float(spec.get("seconds", 1.0)),
            )
        self._lock = threading.Lock()
        self._calls: dict[str, int] = {}
        self._fired: dict[str, int] = {}
        # per-(point, pair) call counters for decide_pair — each network
        # link draws its own deterministic schedule
        self._pair_calls: dict[tuple[str, str], int] = {}

    @classmethod
    def from_spec(cls, spec: dict | str) -> "ChaosPlan":
        """Build from the JSON plan spec (dict, or its serialized form —
        the ``TPU_LIFE_CHAOS`` payload)."""
        if isinstance(spec, str):
            try:
                spec = json.loads(spec)
            except json.JSONDecodeError as e:
                raise ChaosError(f"chaos spec is not valid JSON: {e}") from None
        if not isinstance(spec, dict):
            raise ChaosError(f"chaos spec must be an object, got {spec!r}")
        unknown = set(spec) - {"seed", "points"}
        if unknown:
            raise ChaosError(f"chaos spec has unknown keys {sorted(unknown)}")
        return cls(int(spec.get("seed", 0)), spec.get("points") or {})

    def spec(self) -> dict:
        """The canonical JSON-able spec (round-trips through from_spec)."""
        points = {}
        for name, f in sorted(self.faults.items()):
            p: dict = {"rate": f.rate, "mode": f.mode}
            if f.times is not None:
                p["times"] = f.times
            if f.seconds != 1.0:
                p["seconds"] = f.seconds
            points[name] = p
        return {"seed": self.seed, "points": points}

    def digest(self) -> str:
        """A short stable digest of the canonical spec — stamped into
        drill summaries and BENCH_chaos records next to the seed, so a
        robustness number names exactly the adversity it survived."""
        blob = json.dumps(self.spec(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def _hit(self, fault: Fault, word: int, n: int) -> tuple[bool, int]:
        """ONE pure threefry draw for call ``n`` under counter ``word``:
        ``(fired?, payload draw)``.  The single place the fire predicate
        lives — the live deciders and the preview schedules share it, so
        they can never desynchronize."""
        u0, u1 = threefry2x32(self._k0, self._k1, _np.uint32(word), _np.uint32(n))
        hit = fault.rate >= 1.0 or int(u0) < threshold_u32(fault.rate)
        return hit, int(u1)

    def _decide(
        self, point: str, word: int, counts: dict, ckey
    ) -> Decision | None:
        fault = self.faults.get(point)
        if fault is None:
            return None
        with self._lock:
            n = counts.get(ckey, 0)
            counts[ckey] = n + 1
            if fault.times is not None and self._fired.get(point, 0) >= fault.times:
                return None
            hit, draw = self._hit(fault, word, n)
            if not hit:
                return None
            self._fired[point] = self._fired.get(point, 0) + 1
        return Decision(fault=fault, draw=draw)

    def decide(self, point: str) -> Decision | None:
        """The hot-path decision for one call at ``point``: ``None`` (the
        overwhelmingly common answer) or the fired :class:`Decision`.
        Unarmed points don't count calls — their schedule is independent
        of which other seams happen to be compiled in."""
        return self._decide(
            point, zlib.crc32(point.encode()), self._calls, point
        )

    def decide_pair(self, point: str, pair: str) -> Decision | None:
        """Like :meth:`decide`, but the schedule is keyed by a ``pair``
        label as well (``"router->w1"``): the first counter word mixes
        ``crc32(point) ^ crc32(pair)``, the second counts calls *for that
        pair*, so every network link sees its own pure-function schedule
        under one armed point — a seeded connectivity MASK, not a global
        coin.  ``times`` still bounds total fires across all pairs (a
        partition drill must heal)."""
        word = zlib.crc32(point.encode()) ^ zlib.crc32(pair.encode())
        return self._decide(point, word, self._pair_calls, (point, pair))

    def _preview(
        self, point: str, word: int, calls: int, bound: bool
    ) -> list[bool]:
        fault = self.faults.get(point)
        if fault is None:
            return [False] * calls
        out: list[bool] = []
        fired = 0
        for n in range(calls):
            if bound and fault.times is not None and fired >= fault.times:
                out.append(False)
                continue
            hit, _ = self._hit(fault, word, n)
            out.append(hit)
            fired += hit
        return out

    def preview_pair(self, point: str, pair: str, calls: int) -> list[bool]:
        """The pure fire/no-fire schedule :meth:`decide_pair` would draw
        for one pair's first ``calls`` calls, without the live counters
        (and without the cross-pair ``times`` interaction — this is the
        per-link mask the determinism tests compare)."""
        word = zlib.crc32(point.encode()) ^ zlib.crc32(pair.encode())
        return self._preview(point, word, calls, bound=False)

    def preview(self, point: str, calls: int) -> list[bool]:
        """The pure fire/no-fire schedule for the first ``calls`` calls at
        ``point``, WITHOUT touching the live counters — what the
        determinism tests compare across plans of equal seed."""
        return self._preview(
            point, zlib.crc32(point.encode()), calls, bound=True
        )


# -- the process-global arming seam ------------------------------------------
_PLAN: ChaosPlan | None = None
_INJECTIONS = 0
_COUNTS: dict[tuple[str, str], int] = {}
_REG_FAMILY = None  # optional obs counter family (chaos_injections_total)
_STATE_LOCK = threading.Lock()


def arm(plan: ChaosPlan | dict | str) -> ChaosPlan:
    """Install ``plan`` (a :class:`ChaosPlan` or a spec) process-wide."""
    global _PLAN
    if not isinstance(plan, ChaosPlan):
        plan = ChaosPlan.from_spec(plan)
    _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


def armed() -> bool:
    return _PLAN is not None


def active_plan() -> ChaosPlan | None:
    return _PLAN


@contextlib.contextmanager
def armed_plan(plan: ChaosPlan | dict | str):
    """Scope a plan to a ``with`` block (tests): always disarms on exit."""
    p = arm(plan)
    try:
        yield p
    finally:
        disarm()


def maybe_arm_from_env(env=os.environ) -> ChaosPlan | None:
    """Arm from ``TPU_LIFE_CHAOS`` when set (CLI entry; worker
    subprocesses inherit the exported spec).  A malformed spec raises the
    typed :class:`ChaosError` — a drill must never run un-armed because
    its plan had a typo."""
    raw = env.get(ENV_VAR)
    if not raw:
        return None
    return arm(raw)


def injection_count() -> int:
    """Total injections fired in this process — the zero-overhead-
    disarmed probe (mirrors ``autotune.trial_count`` / ``obs.span_count``):
    the conftest guard asserts it stays 0 across every test that never
    armed a plan, i.e. across the whole tier-1 suite outside the chaos
    tests themselves."""
    return _INJECTIONS


def counts() -> dict[str, dict[str, int]]:
    """Fired injections by point and outcome, for drill summaries."""
    with _STATE_LOCK:
        out: dict[str, dict[str, int]] = {}
        for (point, outcome), n in _COUNTS.items():
            out.setdefault(point, {})[outcome] = n
        return out


def bind_registry(registry) -> None:
    """Register ``chaos_injections_total{point,outcome}`` on an obs
    registry; later fires tick it (the serve/fleet tiers bind their own
    registries so injections surface in /metrics and the JSONL snapshot).
    Binding is unconditional and cheap — the family simply stays at zero
    (and invisible: no primed series) in a disarmed process."""
    global _REG_FAMILY
    _REG_FAMILY = registry.counter(
        "chaos_injections_total",
        "chaos faults injected, by point and outcome",
        labels=("point", "outcome"),
    )


def _record(point: str, outcome: str) -> None:
    global _INJECTIONS
    with _STATE_LOCK:
        _INJECTIONS += 1
        _COUNTS[(point, outcome)] = _COUNTS.get((point, outcome), 0) + 1
    fam = _REG_FAMILY
    if fam is not None:
        fam.labels(point=point, outcome=outcome).inc()
    # the trace marker (docs/OBSERVABILITY.md "Distributed tracing"):
    # every fired injection is an instant event in whatever timeline is
    # active, so a drill's merged trace shows fault <-> latency
    # correlation instead of only counters.  instant() is the standard
    # one-global-check no-op when no tracer is active; a fire only
    # happens under an armed plan, so the disarmed path never gets here.
    _trace.instant("chaos.injection", point=point, decision=outcome)
    # and the flight-recorder twin: injections are postmortem decisions
    _flight.record("injection", point=point, decision=outcome)


# -- the seam helpers (all no-ops when disarmed) -----------------------------
def decide(point: str) -> Decision | None:
    """The generic seam check: the fired :class:`Decision` or ``None``.
    Seams with bespoke behavior (corruption, resets) use this and act on
    the decision themselves, recording via :func:`record_fire`."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.decide(point)


def record_fire(point: str, outcome: str) -> None:
    """Count a fire a seam executed itself (paired with :func:`decide`)."""
    _record(point, outcome)


def inject(point: str) -> None:
    """Raise the configured exception when ``point`` fires; no-op
    otherwise.  The exception TYPE is what the seam's real handlers
    catch — OSError for the spill paths, ``recovery.InjectedFault``
    (RECOVERABLE) for the engine chunk seams — so an injection exercises
    the production handling, not a parallel code path."""
    plan = _PLAN
    if plan is None:
        return
    d = plan.decide(point)
    if d is None:
        return
    _record(point, d.fault.mode)
    mode = d.fault.mode
    if mode == "enospc":
        raise OSError(
            errno.ENOSPC, f"chaos: injected ENOSPC at {point} (seed {plan.seed})"
        )
    if mode == "oserror":
        raise OSError(f"chaos: injected I/O failure at {point} (seed {plan.seed})")
    if mode == "fault":
        from tpu_life_torch.runtime import recovery

        raise recovery.InjectedFault(
            f"chaos: injected device fault at {point} (seed {plan.seed})"
        )
    if mode == "oom":
        from tpu_life_torch.runtime import recovery

        # the message carries the real OOM marker so the production
        # classifier (recovery.is_oom) — and therefore the OOM-specific
        # recovery ladder — is what an injection exercises
        raise recovery.InjectedFault(
            f"RESOURCE_EXHAUSTED: chaos: injected device OOM at {point} "
            f"(seed {plan.seed})"
        )
    raise ChaosError(f"point {point} cannot inject mode {mode}")  # pragma: no cover


def delay(point: str) -> float:
    """Seconds to sleep at a timing seam (0.0 when disarmed / unfired)."""
    plan = _PLAN
    if plan is None:
        return 0.0
    d = plan.decide(point)
    if d is None:
        return 0.0
    _record(point, d.fault.mode)
    return d.fault.seconds


def skew(point: str) -> float:
    """A deterministic clock skew in ``[0, seconds]`` — the draw word
    picks the magnitude, so the skew schedule replays from the seed."""
    plan = _PLAN
    if plan is None:
        return 0.0
    d = plan.decide(point)
    if d is None:
        return 0.0
    _record(point, d.fault.mode)
    return d.fault.seconds * (d.draw / 4294967296.0)


def corrupt(point: str, data: bytes) -> bytes:
    """Mangle published bytes when ``point`` fires: ``bitflip`` flips one
    deterministically chosen bit, ``truncate`` drops the tail — the two
    disk-rot shapes ``snapshot_intact`` exists to catch."""
    plan = _PLAN
    if plan is None or not data:
        return data
    d = plan.decide(point)
    if d is None:
        return data
    _record(point, d.fault.mode)
    if d.fault.mode == "truncate":
        return data[: max(1, len(data) // 2)]
    buf = bytearray(data)
    bit = d.draw % (len(buf) * 8)
    buf[bit // 8] ^= 1 << (bit % 8)
    return bytes(buf)


def partitioned(src: str, dst: str) -> bool:
    """True when the seeded connectivity mask severs the ``src -> dst``
    link for this call (the ``net.partition`` point, drawn per pair via
    :meth:`ChaosPlan.decide_pair`).  Callers translate True into their
    transport's honest unreachable shape — a connect that never
    establishes — so the production partition handling is what runs."""
    plan = _PLAN
    if plan is None:
        return False
    d = plan.decide_pair("net.partition", f"{src}->{dst}")
    if d is None:
        return False
    _record("net.partition", d.fault.mode)
    return True


def crash(point: str) -> None:
    """``os._exit`` the process when ``point`` fires (the worker-crash
    seam: a SIGKILL-grade death — no atexit, no drain, no flush)."""
    plan = _PLAN
    if plan is None:
        return
    d = plan.decide(point)
    if d is None:
        return
    _record(point, d.fault.mode)
    from tpu_life_torch.runtime.metrics import log

    log.error("chaos: injected crash at %s (seed %d)", point, plan.seed)
    os._exit(23)


__all__ = [
    "ENV_VAR",
    "POINTS",
    "ChaosError",
    "ChaosPlan",
    "Decision",
    "Fault",
    "active_plan",
    "arm",
    "armed",
    "armed_plan",
    "bind_registry",
    "corrupt",
    "counts",
    "crash",
    "decide",
    "delay",
    "disarm",
    "inject",
    "injection_count",
    "maybe_arm_from_env",
    "partitioned",
    "record_fire",
    "skew",
]
