"""Worker supervision: spawn, health-check, restart, breaker, drain.

The supervisor owns N gateway worker *subprocesses*
(``python -m tpu_life_torch gateway``
on distinct ephemeral ports — every worker binds port 0 and the bound
port is read back from its startup JSON line, so no port can collide
under parallel CI).  A monitor thread ticks every ``probe_interval_s``:

- **liveness**: ``proc.poll()`` — a dead process is a crash (unless the
  fleet is draining, when exits are the goal);
- **readiness**: ``GET /readyz`` — 200 is READY, 503 is DRAINING, and a
  process that stays unreachable while alive past a threshold is wedged
  and gets killed into the restart path;
- **restart**: crashed workers respawn (a fresh generation, a fresh
  port) after exponential backoff; a worker that keeps dying young —
  ``breaker_threshold`` consecutive failures, each before
  ``healthy_after_s`` of uptime — opens its circuit breaker and is marked
  FAILED, never respawned (a config that crashes on boot must not turn
  the supervisor into a fork bomb).  Surviving ``healthy_after_s`` resets
  the count;
- **drain**: ``begin_drain()`` forwards SIGTERM to every live worker —
  each gateway finishes its in-flight sessions and exits 0 — and stops
  restarting; ``drained()`` turns true once every process is reaped.

With ``placement="auto"`` the supervisor also owns the **per-worker
device seam** (docs/FLEET.md "Device placement"): a planner assigns each
worker a disjoint device slice as an overlay — environment variables and
the gateway's ``--device`` flag (``fleet.placement``) — applied at every
spawn, so a restart or recycle re-enters the dead worker's exact slice,
and each worker's startup line reports the device count/kind its own
torch init actually resolved, which
feeds the capacity-weighted balancer.  A placed worker that dies without
EVER becoming ready fails fast (typed :class:`PlacementError`, breaker
OPEN) instead of burning the restart budget respawning into the same
deterministically bad env.

Everything is injectable (``spawn``, ``probe``, ``clock``) so the restart
and breaker logic unit-test with fake processes and a fake clock; the
default implementations spawn real ``sys.executable -m tpu_life_torch gateway``
subprocesses and probe over real HTTP.
"""

from __future__ import annotations

import enum
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path

from tpu_life_torch import chaos, obs
from tpu_life_torch.fleet.placement import (
    PlacementError,
    apply_env_overlay,
    plan_placements,
)
from tpu_life_torch.gateway import protocol
from tpu_life_torch.runtime.metrics import log

#: Bound on remembered lease-expiry fences (a months-running control
#: plane with a flapping remote worker must not grow without bound).
#: Evicting the OLDEST fence is safe: its generation is long superseded,
#: so ``heartbeat``'s generation-mismatch arm answers the same typed 410.
MAX_FENCES = 10_000


class WorkerState(enum.Enum):
    STARTING = "starting"  # spawned, startup line / first readyz pending
    READY = "ready"  # /readyz answered 200 — in the routing rotation
    DRAINING = "draining"  # /readyz answered 503 (worker-side drain)
    DOWN = "down"  # process exited; restart scheduled (or drain done)
    FAILED = "failed"  # circuit breaker open — never respawned
    STANDBY = "standby"  # parked capacity — no process, out of rotation,
    # recruitable by the autoscaler (docs/FLEET.md "Autoscaling")


@dataclass
class FleetConfig:
    workers: int = 2
    host: str = "127.0.0.1"
    port: int = 0  # router port; 0 = ephemeral (read Fleet.port back)
    #: extra argv appended to ``gateway --host H --port 0`` for every worker
    worker_args: tuple[str, ...] = ()
    #: per-worker JSONL metrics sinks land at <metrics_dir>/<name>.jsonl
    metrics_dir: str | None = None
    #: per-worker stdout+stderr logs (default: a fresh temp dir)
    log_dir: str | None = None
    probe_interval_s: float = 0.25
    startup_timeout_s: float = 30.0  # spawn -> startup line + first readyz
    backoff_base_s: float = 0.5  # restart delay doubles from here
    backoff_max_s: float = 10.0
    breaker_threshold: int = 5  # consecutive fast failures -> FAILED
    healthy_after_s: float = 5.0  # uptime that resets the failure count
    unready_threshold: int = 20  # failed probes while alive -> kill+restart
    depth_ttl_s: float = 0.5  # balancer metrics-scrape cache TTL
    forward_timeout_s: float = 30.0  # router -> worker per-request bound
    max_body: int = protocol.MAX_BODY  # router request-body bound (413)
    max_pins: int = 100_000  # session-registry LRU cap
    #: durable sessions (docs/FLEET.md failover): the spill root.  Each
    #: worker incarnation spills its live sessions under
    #: ``<spill_dir>/<name>g<generation>``; on worker death the migrator
    #: resumes the intact spills on a survivor under the SAME fleet sid.
    #: None = durability off (worker death answers 410 worker_lost).
    spill_dir: str | None = None
    spill_every: int = 4  # rounds between worker spill passes
    #: remote spill store (docs/FLEET.md "Cross-host topology"): workers
    #: spill through this HTTP store instead of a local directory, under
    #: per-incarnation namespaces (``<site><name>g<gen>``), so migration
    #: reads work when the rescuer shares no filesystem with the victim.
    #: Mutually exclusive with ``spill_dir``.
    spill_url: str | None = None
    #: this control plane's namespace prefix in a SHARED spill store (two
    #: fleets sharing one store must not collide on ``w0g1``); also the
    #: orphan-sweep scope — a fleet only ever reaps its own site's
    #: namespaces.  Letters/digits/dash, e.g. ``"a-"``.
    site: str = ""
    #: peer control planes (router URLs): when every LOCAL survivor
    #: refuses a rescue, the migrator re-submits the spilled session to a
    #: peer fleet — cross-host failure masking (docs/FLEET.md).
    peers: tuple[str, ...] = ()
    #: lease TTL for wire-registered workers; their heartbeats renew it,
    #: and an un-renewed lease fires the same migration hook a local
    #: process death does, then FENCES the generation (typed
    #: ``lease_expired`` on reconnect — never split-brain re-admission)
    lease_ttl_s: float = 15.0
    migrate_timeout_s: float = 30.0  # per-session resume budget on death
    #: stuck-MIGRATING watchdog (docs/CHAOS.md): a sid still answering
    #: "migrating" this long after its run activated (or after the
    #: rescue-imminent fallback first covered it) settles to a terminal
    #: 410 ``migration_failed`` — a dead migrator thread must not leave
    #: clients polling synthetic progress forever
    migrate_stuck_after_s: float = 120.0
    #: device placement (docs/FLEET.md "Device placement"): ``"none"``
    #: keeps today's shared spawning env byte-for-byte; ``"auto"`` plans a
    #: disjoint device slice per worker and applies it as an env overlay
    #: at every spawn (restarts re-apply the dead worker's slice)
    placement: str = "none"
    #: per-worker device counts for the planner (normalized: one entry
    #: per worker); None = auto split (one forced host device each on
    #: cpu, an even slice of ``total_devices`` on accelerators)
    devices_per_worker: tuple[int, ...] | None = None
    #: how many real devices the host has (cuda/gpu placement only — the
    #: torch-free front tier cannot count cards itself)
    total_devices: int | None = None
    #: platform kind the planner targets (the port's names: cpu / cuda,
    #: gpu an alias of cuda)
    placement_platform: str = "cpu"
    #: fleet trace collection (docs/OBSERVABILITY.md "Distributed
    #: tracing"): when set, every worker runs with an active tracer
    #: (``--trace-events <trace_dir>/<name>g<gen>.trace.json``) and the
    #: monitor tick DRAINS each worker's span + flight rings over
    #: ``GET /v1/debug/trace`` into ``<trace_dir>/<name>.jsonl`` (one
    #: scrape record per line, with a handshake-estimated clock offset),
    #: plus this control plane's own flight ring into ``control.jsonl``
    #: — the capture set ``tpu-life trace merge`` fuses into one
    #: Perfetto timeline.  None = no collection (zero new requests).
    trace_dir: str | None = None
    #: fleet series collection (docs/OBSERVABILITY.md "Time series"):
    #: the monitor tick scrapes every live worker's snapshot ring over
    #: ``GET /v1/debug/series?cursor=`` into a per-(worker, generation)
    #: store — the SLO engine's data plane — at most once per this many
    #: seconds, and samples the fleet's own registry (the control
    #: series: router/lease/shed counters) on the same cadence.  With
    #: ``trace_dir`` set the scrapes also land in ``<name>.series.jsonl``
    #: capture files for offline replay.  0 disables collection.
    series_every_s: float = 1.0
    #: declarative SLO specs (docs/OBSERVABILITY.md "SLOs and burn
    #: rates"): a JSON/TOML spec file evaluated with multi-window burn
    #: rates on the monitor tick; None = the built-in defaults.  A bad
    #: spec file raises at construction, before any process exists.
    slo_file: str | None = None
    #: standby pool (docs/FLEET.md "Autoscaling"): this many EXTRA worker
    #: slots created parked — no process, out of the routing rotation —
    #: that ``recruit()`` launches on demand and ``release()`` returns
    #: capacity to.  Under placement auto the plan covers the full
    #: ``workers + standby`` set, so a recruit enters a reserved slice.
    standby: int = 0
    #: the autoscaling policy (an ``AutoscaleConfig``); None = no control
    #: loop (standby stays parked unless an operator recruits by hand)
    autoscale: object | None = None


@dataclass
class Worker:
    """One supervised gateway: process + bound URL + health state."""

    name: str
    log_path: Path
    generation: int = 0
    proc: subprocess.Popen | None = None
    url: str | None = None
    run_id: str | None = None
    state: WorkerState = WorkerState.DOWN
    started_at: float = 0.0
    restart_at: float = 0.0
    failures: int = 0  # consecutive fast failures (breaker input)
    unready: int = 0  # consecutive failed probes while alive
    #: machine-readable reason from the last 500 /readyz answer (e.g.
    #: ``engine_wedged:settle_deadline`` from the serve wedge watchdog,
    #: docs/SERVING.md "Resource governance") — surfaced in /healthz and
    #: the fleet summary so an unready-recycle names WHY it fired; None
    #: for plain unreachability, cleared on the next ready/draining probe
    unready_reason: str | None = None
    log_offset: int = 0  # startup line scan starts here (per generation)
    exit_codes: list[int] = field(default_factory=list)
    #: placement env overlay applied at every spawn of this worker —
    #: stable across generations, so a restart re-enters the SAME slice
    env_overlay: dict = field(default_factory=dict)
    #: the placement's gateway flags (``--device cpu|cuda``), appended to
    #: every spawn's argv with the overlay
    placement_args: tuple[str, ...] = ()
    #: resolved device count/kind, reported by the worker's startup line
    #: (planned values until the first report lands)
    devices: int | None = None
    device_kind: str | None = None
    #: True once ANY generation answered ready — the placed-worker
    #: fail-fast gate (a slice that never came up is presumed invalid)
    ever_ready: bool = False
    #: True while the SUPERVISOR is killing this worker (startup timeout,
    #: unready recycle): that exit is self-inflicted — possibly just a
    #: slow attach — and must ride the restart budget, never the
    #: placement fail-fast
    recycling: bool = False
    #: wire-registered membership (docs/FLEET.md "Cross-host topology"):
    #: True for workers the control plane did NOT spawn — they registered
    #: over HTTP, hold a heartbeat-renewed lease, and are never respawned
    #: by us (a fresh registration IS their respawn)
    remote: bool = False
    lease_expires_at: float = 0.0
    #: the lease expired (or the fleet drained): this incarnation is
    #: fenced — terminal until the worker re-registers a new generation
    lease_dead: bool = False
    #: standby-pool membership (docs/FLEET.md "Autoscaling"): this slot
    #: parks at STANDBY instead of respawning after a release — set at
    #: construction for the ``--standby`` tail, and stamped onto any
    #: worker ``release()`` drains (a released base worker IS returned
    #: capacity; recruit can bring it back)
    standby: bool = False
    #: a per-worker scale-down drain is in flight: the next exit re-parks
    #: this slot at STANDBY instead of scheduling a restart
    released: bool = False

    @property
    def alive(self) -> bool:
        if self.remote:
            # a remote worker is "alive" exactly while its lease stands:
            # there is no process to poll, only the claim it keeps renewing
            return self.url is not None and not self.lease_dead
        return self.proc is not None and self.proc.poll() is None


class Supervisor:
    """Owns the workers and the monitor thread; exposes the routing view
    (:meth:`ready_workers`) and the drain choreography."""

    def __init__(
        self,
        config: FleetConfig,
        registry,
        *,
        spawn=None,
        probe=None,
        clock=time.monotonic,
    ):
        self.config = config
        if config.spill_url is not None and config.spill_dir is not None:
            raise ValueError(
                "spill_dir and spill_url are mutually exclusive (a fleet "
                "spills locally OR through the remote store, never both)"
            )
        if not re.fullmatch(r"(?:[A-Za-z0-9][A-Za-z0-9-]*)?", config.site):
            raise ValueError(
                f"site must be letters/digits/dash starting with an "
                f"alphanumeric (a spill-namespace prefix), got {config.site!r}"
            )
        self.clock = clock
        self.spawn = spawn or self._default_spawn
        self.probe = probe or self._default_probe
        self._lock = threading.RLock()
        self._draining = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        log_dir = Path(config.log_dir or tempfile.mkdtemp(prefix="tpu-life-fleet-"))
        log_dir.mkdir(parents=True, exist_ok=True)
        self.log_dir = log_dir
        self.workers = [
            Worker(name=f"w{i}", log_path=log_dir / f"w{i}.log")
            for i in range(config.workers + max(0, config.standby))
        ]
        # the standby tail parks at construction: no process, out of the
        # rotation, waiting for recruit() (docs/FLEET.md "Autoscaling")
        for w in self.workers[config.workers:]:
            w.standby = True
            w.state = WorkerState.STANDBY
        # device placement (docs/FLEET.md): plan ONCE, at construction —
        # an invalid plan (oversubscribed slice, unknown platform) raises
        # the typed PlacementError here, before any process exists, so a
        # deterministically broken env never burns the restart budget
        self.placements = None
        if config.placement == "auto":
            # the plan covers the standby tail too: a recruit must enter
            # a RESERVED disjoint slice, not squat on a live worker's
            self.placements = plan_placements(
                config.workers + max(0, config.standby),
                platform=config.placement_platform,
                devices_per_worker=config.devices_per_worker,
                total_devices=config.total_devices,
            )
            for w, p in zip(self.workers, self.placements):
                w.env_overlay = dict(p.env)
                w.placement_args = p.args
                w.devices = p.devices  # planned; startup line overwrites
                w.device_kind = p.kind
        elif config.placement != "none":
            raise PlacementError(
                f"unknown placement policy {config.placement!r} "
                f"(expected auto or none)"
            )
        #: worker-death callback: ``cb(name, generation)`` fires (under
        #: the supervisor lock — keep it fast) for every non-drain exit
        #: AND every lease expiry; the fleet wires the migrator's spill
        #: rescue here
        self.on_worker_exit = None
        #: fenced incarnations (docs/FLEET.md "Cross-host topology"): a
        #: (name, generation) whose lease expired after its sessions were
        #: re-homed — its heartbeats are refused with the typed 410
        #: ``lease_expired``, never silently re-admitted.  Insertion-
        #: ordered and bounded (a months-running plane with a flapping
        #: remote worker must not grow without bound): an evicted fence
        #: is generations-superseded, and ``heartbeat``'s generation-
        #: mismatch arm still answers it the same typed 410
        self._fenced: OrderedDict[tuple[str, int], None] = OrderedDict()
        #: fences created by begin_drain rather than a lease expiry: the
        #: worker's sessions were NOT re-homed, so its heartbeats answer
        #: the typed 503 ``draining`` (finish your sessions, re-register
        #: later) instead of the 410 that tells it to drop everything
        self._drain_fenced: set[tuple[str, int]] = set()
        #: chaos-injection retention (docs/CHAOS.md): last-seen
        #: ``chaos_injections_total`` per (worker, generation, point,
        #: outcome), scraped continuously while a plan is armed — a dead
        #: worker's counters no longer die with its registry, so drill
        #: accounting is per-incarnation exact instead of a pre-kill floor
        self._injections: dict[tuple[str, int, str, str], float] = {}
        self._g_workers = registry.gauge(
            "fleet_workers", "supervised workers by state", labels=("state",)
        )
        self._c_restarts = registry.counter(
            "fleet_restarts_total", "worker respawns after a crash"
        )
        self._c_restarts.labels()
        # the lease instruments (docs/FLEET.md "Cross-host topology")
        self._c_lease_expired = registry.counter(
            "fleet_lease_expired_total",
            "remote-worker leases expired un-renewed (fires migration)",
        )
        self._c_lease_expired.labels()
        self._c_lease_refused = registry.counter(
            "fleet_lease_refusals_total",
            "heartbeats refused because the (worker, generation) is fenced",
        )
        self._c_lease_refused.labels()
        self._c_registrations = registry.counter(
            "fleet_registrations_total", "wire registrations accepted"
        )
        self._c_registrations.labels()
        self._g_injections = registry.gauge(
            "fleet_chaos_injections",
            "last-seen chaos_injections_total per worker (survives death)",
            labels=("worker", "point", "outcome"),
        )
        self._g_devices = registry.gauge(
            "fleet_worker_devices",
            "devices resolved by each worker (planned until reported)",
            labels=("worker",),
        )
        # fleet trace collection (docs/OBSERVABILITY.md): capture-file
        # appends come from the monitor thread and close() — serialized
        # here.  _doomed carries (worker, generation, url) recycle
        # victims whose kill is DEFERRED past the lock so their final
        # trace scrape (bounded HTTP) never stalls the routing hot path.
        self._capture_lock = threading.Lock()
        self._doomed: list[tuple] = []
        # fleet series collection + the SLO engine (docs/OBSERVABILITY.md
        # "Time series" / "SLOs and burn rates"): the per-(worker,
        # generation) snapshot store the tick scrapes into, the cursors
        # it owns (the worker's ring read is non-destructive), this
        # process's own registry ring (the control series), and the burn-
        # rate engine judging the store every collection pass.  A bad
        # --slo file raises HERE, before any process exists — like a bad
        # placement plan.
        self._registry = registry
        self.series_store = obs.timeseries.SeriesStore()
        self._series_cursors: dict[tuple[str, int], int] = {}
        self._control_series = obs.timeseries.SeriesRing()
        self._series_next = 0.0
        specs = (
            obs.slo.load_specs(config.slo_file)
            if config.slo_file is not None
            else obs.slo.default_specs()
        )
        self.slo_engine = obs.slo.SloEngine(specs, self.series_store)
        # demand-driven autoscaling (docs/FLEET.md "Autoscaling"): the
        # control loop joins the monitor tick at the series cadence —
        # its data plane IS the series store the tick already fills
        self.autoscaler = None
        if config.autoscale is not None:
            from tpu_life_torch.fleet.autoscaler import Autoscaler

            self.autoscaler = Autoscaler(config.autoscale, self)
        for st in WorkerState:
            self._g_workers.labels(state=st.value).set(0.0)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._sweep_orphan_spills()
        with self._lock:
            for w in self.workers:
                if w.state is not WorkerState.STANDBY:
                    self._spawn_worker(w, first=True)
            self._update_gauges()
        self._thread = threading.Thread(
            target=self._monitor, name="fleet-monitor", daemon=True
        )
        self._thread.start()

    def _sweep_orphan_spills(self) -> None:
        """Startup sweep: delete spill directories left by dead
        generations of a PREVIOUS supervisor run.  This supervisor's
        generations all start fresh (and get fresh per-generation dirs),
        so at start every existing subdirectory is an orphan — without
        this, a crashed worker's directory would sit on disk forever
        (in-run orphans are deleted by the migrator after each rescue)."""
        if self.config.spill_url is not None:
            # the remote twin: reap THIS SITE's namespaces from the shared
            # store.  An empty site would sweep every fleet sharing the
            # store, so the sweep is gated on a non-empty prefix (a solo
            # fleet that wants the reap names a site; docs/FLEET.md).
            if not self.config.site:
                log.debug("fleet: no site prefix — skipping remote spill sweep")
                return
            from tpu_life_torch.serve.spill_http import (
                delete_remote_namespace,
                list_remote_namespaces,
            )

            try:
                spaces = list_remote_namespaces(self.config.spill_url)
            except OSError as e:
                # the store may simply not be up yet: durability degrades,
                # the fleet must still come up
                log.warning("fleet: remote spill sweep skipped: %s", e)
                return
            for ns in spaces:
                if ns.startswith(self.config.site):
                    log.info("fleet: sweeping orphan remote namespace %s", ns)
                    delete_remote_namespace(self.config.spill_url, ns)
            return
        if self.config.spill_dir is None:
            return
        root = Path(self.config.spill_dir)
        if not root.is_dir():
            return
        import shutil

        for child in root.iterdir():
            if child.is_dir():
                log.info("fleet: sweeping orphan spill dir %s", child)
                shutil.rmtree(child, ignore_errors=True)

    def begin_drain(self) -> None:
        """Fleet-wide graceful drain: SIGTERM every live worker (each
        gateway finishes in-flight sessions and exits 0) and stop
        restarting.  Idempotent — but a repeat call re-TERMs anything
        still alive, so a signal that raced a worker spawn (or a second
        SIGTERM from an impatient operator) is never silently dropped.
        Callers block on :meth:`wait`."""
        with self._lock:
            first = not self._draining
            self._draining = True
            for w in self.workers:
                if w.remote:
                    # not ours to signal: revoke the lease and fence the
                    # generation — but as a DRAIN fence, so a late
                    # heartbeat gets the typed 503 ``draining`` (its
                    # sessions were not re-homed; it must finish them,
                    # not drop them) rather than the 410 fence
                    if not w.lease_dead:
                        self._fence_locked(w)
                        self._drain_fenced.add((w.name, w.generation))
                        w.lease_dead = True
                        w.state = WorkerState.DOWN
                    continue
                if w.alive:
                    if first:
                        log.info("fleet: draining %s (pid %d)", w.name, w.proc.pid)
                    w.proc.terminate()

    @property
    def draining(self) -> bool:
        return self._draining

    def drained(self) -> bool:
        """True once every worker process is gone (reaped or never up)."""
        with self._lock:
            return all(not w.alive for w in self.workers)

    def finished(self) -> bool:
        """True when this supervisor will never run another worker: a
        requested drain completed, OR every worker opened its circuit
        breaker (a fleet that crash-loops to all-FAILED must surface as
        exit 1, not hang serving 503s until someone signals it)."""
        with self._lock:
            if self.workers and all(
                w.state is WorkerState.FAILED for w in self.workers
            ):
                return True
            return self._draining and all(not w.alive for w in self.workers)

    def wait(self, timeout: float | None = None) -> bool:
        """Block (in signal-friendly slices) until :meth:`finished`."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.finished():
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.05)
        return True

    def close(self) -> None:
        """Stop the monitor and hard-kill anything still alive."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.config.trace_dir is not None or self.config.series_every_s > 0:
            # last evidence pass: whatever the workers buffered since the
            # final monitor tick, plus this process's own flight tail
            with self._lock:
                targets = [
                    (w, w.generation, w.url)
                    for w in self.workers
                    if w.url is not None and w.alive
                ]
            if self.config.trace_dir is not None:
                self._scrape_traces(targets)
                self._scrape_control()
            if self.config.series_every_s > 0:
                self._scrape_series(targets)
                self._sample_control_series()
        with self._lock:
            for w in self.workers:
                if w.proc is not None and w.proc.poll() is None:
                    w.proc.kill()
            for w in self.workers:
                if w.proc is not None:
                    try:
                        w.proc.wait(timeout=5)
                    except subprocess.TimeoutExpired:  # pragma: no cover
                        log.warning("fleet: %s did not die on SIGKILL", w.name)

    # -- the routing view --------------------------------------------------
    def ready_workers(self) -> list[Worker]:
        # liveness-checked on read: a freshly dead worker leaves the
        # rotation immediately, not at the monitor's next tick
        with self._lock:
            return [
                w
                for w in self.workers
                if w.state is WorkerState.READY and w.alive
            ]

    def get(self, name: str) -> Worker | None:
        for w in self.workers:
            if w.name == name:
                return w
        return None

    def states(self) -> dict[str, str]:
        with self._lock:
            out = {}
            for w in self.workers:
                st = w.state
                if (
                    st
                    not in (
                        WorkerState.DOWN,
                        WorkerState.FAILED,
                        WorkerState.STANDBY,  # parked: no process BY DESIGN
                    )
                    and not w.alive
                ):
                    st = WorkerState.DOWN  # dead but not yet reaped by a tick
                out[w.name] = st.value
            return out

    def unready_reasons(self) -> dict[str, str]:
        """Workers currently refusing their probe WITH a typed reason
        (``code[:reason]``, e.g. ``engine_wedged:settle_deadline``) — the
        why behind an in-flight unready-recycle (docs/FLEET.md)."""
        with self._lock:
            return {
                w.name: w.unready_reason
                for w in self.workers
                if w.unready_reason is not None
            }

    def capacities(self) -> dict:
        """Per-worker capacity view for ``/healthz`` / ``stats``: resolved
        (or planned) device count + kind, and the routing weight the
        balancer normalizes queue depth by."""
        with self._lock:
            return {
                w.name: {
                    "devices": w.devices,
                    "device_kind": w.device_kind,
                    "weight": worker_weight(w),
                }
                for w in self.workers
            }

    def devices_total(self) -> int:
        """The fleet's aggregate device count — the capacity-planning
        number.  Slices are disjoint only under placement auto, so only
        then do per-worker counts SUM; under the shared spawning env
        (placement none) every worker co-claims ONE device set, and the
        honest aggregate is that set's size (the max report), not
        workers x it."""
        with self._lock:
            values = [w.devices or 0 for w in self.workers]
        if self.placements is not None:
            return sum(values)
        return max(values, default=0)

    def restarts(self) -> float:
        return self._c_restarts.value

    # -- demand-driven scaling (docs/FLEET.md "Autoscaling") ----------------
    def scale_counts(self) -> tuple[int, int]:
        """``(active, standby)``: slots currently deployed (ready,
        starting, draining, or local-and-restarting) vs parked slots a
        :meth:`recruit` could launch right now."""
        with self._lock:
            active = standby = 0
            for w in self.workers:
                if w.state is WorkerState.STANDBY:
                    if not w.remote or not w.lease_dead:
                        standby += 1
                elif w.state in (
                    WorkerState.STARTING,
                    WorkerState.READY,
                    WorkerState.DRAINING,
                ):
                    active += 1
                elif w.state is WorkerState.DOWN and not w.remote:
                    # a local DOWN worker has a restart scheduled: still
                    # a deployed slot, just mid-bounce
                    active += 1
            return active, standby

    def recruit(self) -> str | None:
        """Launch one parked standby into the fleet: spawn it (local) or
        start probing it (a pre-registered remote standby — its gateway
        is already up, parked out of rotation).  Returns the worker's
        name, or None when the pool is empty / the fleet is draining /
        the ``scale.recruit.fail`` chaos point says the launch failed —
        the caller (the autoscaler) holds and retries next evaluation."""
        with self._lock:
            if self._draining:
                return None
            cands = [
                w
                for w in self.workers
                if w.state is WorkerState.STANDBY
                and (not w.remote or not w.lease_dead)
            ]
            if not cands:
                return None
            if chaos.decide("scale.recruit.fail") is not None:
                # the "standby failed to launch" drill: no spawn, no
                # state change — deterministic, and the next evaluation
                # simply tries again
                chaos.record_fire("scale.recruit.fail", "refuse")
                log.warning("fleet: recruit refused (chaos scale.recruit.fail)")
                return None
            w = cands[0]
            if w.remote:
                # the parked gateway is live and leased: recruiting is
                # just re-entering the probe rotation
                w.state = WorkerState.STARTING
                w.started_at = self.clock()
                w.unready = 0
            else:
                self._spawn_worker(w)
            obs.flight.record(
                "scale.recruit",
                worker=w.name,
                generation=w.generation,
                remote=w.remote,
            )
            self._update_gauges()
            return w.name

    def release(self, name: str) -> bool:
        """Drain ONE worker out of the fleet and return its slot to the
        standby pool: the graceful per-worker twin of
        :meth:`begin_drain` — SIGTERM a local worker (its gateway
        finishes accepted sessions, then exits; the exit re-parks the
        slot) or drain-fence a remote one (typed 503 heartbeats tell it
        to finish its sessions and re-register later).  Mesh-slice
        reservations and sid pins are respected for free: the worker
        itself retires them as its sessions complete."""
        with self._lock:
            w = self.get(name)
            if w is None or self._draining:
                return False
            if w.remote:
                if w.lease_dead or w.state is WorkerState.STANDBY:
                    return False
                self._fence_locked(w)
                self._drain_fenced.add((w.name, w.generation))
                w.lease_dead = True
                w.standby = True
                w.state = WorkerState.DOWN
            else:
                if not w.alive or w.released:
                    return False
                w.released = True
                w.proc.terminate()
            obs.flight.record(
                "scale.release",
                worker=w.name,
                generation=w.generation,
                remote=w.remote,
            )
            self._update_gauges()
            return True

    # -- the monitor -------------------------------------------------------
    def _monitor(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # pragma: no cover - monitor must not die
                log.exception("fleet: monitor tick failed")
            if self.finished():
                # reaping is done (or every breaker opened); keep gauges
                # truthful and stop ticking
                with self._lock:
                    self._update_gauges()
                return
            self._stop.wait(self.config.probe_interval_s)

    def tick(self) -> None:
        """One monitor pass (public so unit tests drive it directly).

        Two phases around the lock: process lifecycle (exits, respawns,
        startup-line reads — fast and local) runs under it; the ``/readyz``
        HTTP probes (up to 1 s each against a wedged-but-alive worker) run
        OUTSIDE it, so a slow worker can never stall the router's
        ``ready_workers()`` / ``states()`` hot path for the probe's
        duration.  Probe answers are re-validated against the generation
        before applying — the world may have moved while we waited.
        """
        # chaos seam (docs/CHAOS.md): the monitor's clock reads skewed by
        # a bounded, seeded amount — the "NTP stepped the clock" drill.
        # Every deadline decision this tick makes (startup timeout,
        # backoff expiry, healthy-uptime reset) sees the same skew, and
        # the fleet must stay consistent: a skew-provoked kill is
        # supervisor-initiated and rides the normal restart budget.
        now = self.clock() + chaos.skew("probe.skew")
        to_probe: list[tuple[Worker, int]] = []
        with self._lock:
            for w in self.workers:
                if self._tick_liveness(w, now):
                    to_probe.append((w, w.generation))
            self._update_gauges()
        if to_probe:
            results = self._probe_all(to_probe)
            with self._lock:
                for w, gen, status in results:
                    if (
                        w.generation != gen
                        or not w.alive
                        or w.state in (WorkerState.DOWN, WorkerState.FAILED)
                    ):
                        continue  # stale answer: the next tick sees the truth
                    self._apply_probe(w, status, now)
                self._update_gauges()
        self._reap_doomed()
        # fleet trace collection (docs/OBSERVABILITY.md): drain every
        # live worker's span + flight rings into the capture dir —
        # continuous, like the chaos-counter scrape, so a SIGKILL
        # loses at most one tick's events.  Runs OUTSIDE the lock.
        if self.config.trace_dir is not None:
            with self._lock:
                targets = [
                    (w, w.generation, w.url)
                    for w in self.workers
                    if w.url is not None and w.alive
                ]
            self._scrape_traces(targets)
            self._scrape_control()
        # fleet series collection + SLO evaluation (docs/OBSERVABILITY.md):
        # scrape every live worker's snapshot ring, sample the fleet's own
        # registry, then judge the store's windows — rate-limited to one
        # pass per series_every_s whatever the probe cadence is.  Runs
        # OUTSIDE the lock like the trace scrape (max, not sum, latency).
        if self.config.series_every_s > 0 and now >= self._series_next:
            self._series_next = now + self.config.series_every_s
            with self._lock:
                targets = [
                    (w, w.generation, w.url)
                    for w in self.workers
                    if w.url is not None and w.alive
                ]
            self._scrape_series(targets)
            self._sample_control_series()
            try:
                self.slo_engine.evaluate()
            except Exception:  # pragma: no cover - alerting must not kill ticks
                log.exception("fleet: slo evaluation failed")
            # the autoscaler rides the same cadence: its inputs are the
            # windows this very pass just refreshed
            if self.autoscaler is not None and not self._draining:
                try:
                    self.autoscaler.evaluate(now)
                except Exception:  # pragma: no cover - scaling must not kill ticks
                    log.exception("fleet: autoscale evaluation failed")

    def slo_status(self) -> dict:
        """The live burn gauges (``/healthz`` ``slo`` section, ``top``)."""
        return self.slo_engine.status()

    def _probe_all(self, targets: list[tuple[Worker, int]]) -> list[tuple]:
        """Probe workers CONCURRENTLY: tick latency must be max(probe),
        not sum(probe) — with several wedged workers each burning their
        full HTTP timeout, sequential probes would stretch every tick by
        the sum and lag healthy workers' state transitions behind it."""
        if len(targets) == 1:
            w, gen = targets[0]
            return [(w, gen, self.probe(w))]
        results: list = [None] * len(targets)

        def one(i: int, w: Worker, gen: int) -> None:
            results[i] = (w, gen, self.probe(w))

        threads = [
            threading.Thread(target=one, args=(i, w, gen), daemon=True)
            for i, (w, gen) in enumerate(targets)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()  # bounded: the probe itself carries an HTTP timeout
        return [r for r in results if r is not None]

    def _tick_liveness(self, w: Worker, now: float) -> bool:
        """Lifecycle transitions under the lock; True = probe this worker
        over HTTP (it is alive with a bound URL)."""
        if w.state is WorkerState.FAILED:
            return False
        if w.state is WorkerState.STANDBY:
            # parked capacity: no process to reap, no probe to run.  A
            # REMOTE standby still holds a heartbeat-renewed lease; one
            # that goes silent leaves the pool (fenced, so a zombie
            # reconnect is refused typed) — but held no sessions, so no
            # migration fires
            if w.remote and not w.lease_dead and now > w.lease_expires_at:
                log.warning(
                    "fleet: standby %s gen %d stopped heartbeating — "
                    "leaving the pool",
                    w.name,
                    w.generation,
                )
                self._fence_locked(w)
                w.lease_dead = True
                self._c_lease_expired.inc()
                obs.flight.record(
                    "lease.expired",
                    worker=w.name,
                    generation=w.generation,
                    standby=True,
                )
            return False
        if w.remote:
            # wire-registered: liveness is the lease, not a process.  An
            # un-renewed lease is this tier's "the process exited" — same
            # hook, same migration, plus the generation fence.
            if w.lease_dead:
                return False
            if now > w.lease_expires_at:
                self._expire_lease_locked(w)
                return False
            return w.url is not None
        if w.proc is not None and w.proc.poll() is not None:
            self._on_exit(w, now)
            return False
        if w.state is WorkerState.DOWN:
            if not self._draining and now >= w.restart_at:
                self._spawn_worker(w)
            return False  # freshly spawned: startup line read next tick
        if w.state is WorkerState.STARTING and w.url is None:
            doc = self._read_startup(w)
            if doc is None:
                if now - w.started_at > self.config.startup_timeout_s:
                    log.warning(
                        "fleet: %s produced no startup line in %.0fs; killing",
                        w.name,
                        self.config.startup_timeout_s,
                    )
                    w.recycling = True
                    w.proc.kill()
                return False
            w.url = doc["url"]
            w.run_id = doc.get("run_id")
            # the capacity-feedback half of placement: what the worker's
            # OWN jax init resolved wins over the planner's intent — the
            # balancer weights by what the chips actually came up as
            if doc.get("devices"):
                w.devices = int(doc["devices"])
                w.device_kind = doc.get("device_kind") or w.device_kind
            log.info(
                "fleet: %s gen %d at %s (%s device(s), kind %s)",
                w.name,
                w.generation,
                w.url,
                w.devices if w.devices is not None else "?",
                w.device_kind or "?",
            )
        return True

    def _apply_probe(self, w: Worker, status, now: float) -> None:
        # the default probe answers ("ready", <readyz doc>) so capacity
        # reported AFTER the startup line (device resolution is async in
        # the worker — a slow attach must not block its readiness) still
        # reaches the balancer; injected fakes may answer plain strings
        info = None
        if isinstance(status, tuple):
            status, info = status
        if isinstance(info, dict) and "_chaos_injections" in info:
            # the piggybacked injection scrape (docs/CHAOS.md): fold it
            # into the per-incarnation retention whatever the readiness
            # verdict was — evidence is evidence
            self._record_injections_locked(w, info.pop("_chaos_injections"))
        if status == "ready":
            was_ready = w.state is WorkerState.READY
            w.state = WorkerState.READY
            w.ever_ready = True
            w.unready = 0
            w.unready_reason = None
            if not was_ready:
                # the recovery-time SLO's closing edge: a name that had
                # an open outage just answered ready again
                self.slo_engine.note_worker_ready(
                    w.name, w.generation, time.time()
                )
            if isinstance(info, dict) and info.get("devices"):
                w.devices = int(info["devices"])
                w.device_kind = info.get("device_kind") or w.device_kind
            if w.failures and now - w.started_at >= self.config.healthy_after_s:
                w.failures = 0  # survived long enough: breaker resets
        elif status == "draining":
            w.state = WorkerState.DRAINING
            w.unready = 0
            w.unready_reason = None
        else:  # unreachable
            # a reasoned refusal (the worker answered 500 with a typed
            # body — e.g. the serve wedge watchdog's engine_wedged) is
            # still UNREACHABLE for recycle purposes, but the reason is
            # retained so /healthz and the summary name why the recycle
            # fired instead of showing an anonymous probe failure
            if isinstance(info, dict) and info.get("unready_reason"):
                w.unready_reason = str(info["unready_reason"])
            if w.state is WorkerState.STARTING:
                if now - w.started_at > self.config.startup_timeout_s:
                    log.warning("fleet: %s never became ready; killing", w.name)
                    if w.remote:
                        # no process to kill: revoke the lease — the
                        # worker re-registers when (if) it can reach us
                        self._expire_lease_locked(w)
                    else:
                        self._kill_for_recycle_locked(w)
                return
            w.unready += 1
            if w.unready >= self.config.unready_threshold:
                log.warning(
                    "fleet: %s unresponsive for %d probes; killing for restart",
                    w.name,
                    w.unready,
                )
                if w.remote:
                    self._expire_lease_locked(w)
                else:
                    self._kill_for_recycle_locked(w)

    def _on_exit(self, w: Worker, now: float) -> None:
        rc = w.proc.poll()
        w.exit_codes.append(rc)
        w.proc = None
        w.url = None
        w.unready = 0
        # the journey's kill marker: a worker incarnation left the fleet
        # (crash, SIGKILL, recycle, or drain exit) — what the doctor
        # anchors a migration gap's left edge on
        obs.flight.record(
            "worker.exit",
            worker=w.name,
            generation=w.generation,
            rc=rc,
            draining=self._draining,
            recycling=w.recycling,
            released=w.released,
        )
        if not self._draining and not w.released:
            # the recovery-time SLO's clock starts at the death edge (a
            # drain exit — fleet-wide or a scale-down release — is the
            # goal, not an outage)
            self.slo_engine.note_worker_exit(w.name, w.generation, time.time())
        if self._draining:
            w.state = WorkerState.DOWN
            log.info("fleet: %s exited rc=%s (drain)", w.name, rc)
            return
        if self.on_worker_exit is not None:
            # the durability hook: hand this incarnation's spills to the
            # migrator BEFORE any respawn bumps the generation (the hook
            # only records state and spawns a thread — it must stay fast,
            # we hold the supervisor lock).  A released worker gets it
            # too, as a safety net: a graceful release finishes its
            # sessions (nothing to rescue), but one that died MID-drain
            # leaves spills the migrator must still re-home.
            try:
                self.on_worker_exit(w.name, w.generation)
            except Exception:  # pragma: no cover - the hook must not kill reaping
                log.exception("fleet: worker-exit hook failed for %s", w.name)
        if w.released:
            # a scale-down release completing: the slot returns to the
            # standby pool (docs/FLEET.md "Autoscaling") — recruitable
            # again, never auto-respawned, breaker history cleared (an
            # intentional exit is not a crash)
            w.released = False
            w.standby = True
            w.failures = 0
            w.unready_reason = None
            w.state = WorkerState.STANDBY
            log.info(
                "fleet: %s exited rc=%s (released to standby pool)", w.name, rc
            )
            return
        if w.env_overlay and not w.ever_ready and not w.recycling:
            # a PLACED worker that died ON ITS OWN without ever answering
            # ready: its device slice is presumed invalid
            # (oversubscription the planner could not see, a hostile
            # visible-device var, ...).  The overlay is re-applied
            # verbatim on every respawn, so retrying is deterministic
            # failure — fail fast with the typed placement error instead
            # of burning the restart budget respawning into the same bad
            # env.  A supervisor-initiated kill (startup timeout, unready
            # recycle — ``recycling``) is excluded: that may be nothing
            # more than a slow device attach, and it takes the normal
            # restart/backoff/breaker path like an unplaced worker.
            w.failures += 1
            w.state = WorkerState.FAILED
            err = PlacementError(
                f"worker {w.name} exited rc={rc} before ever becoming "
                f"ready under placement overlay {w.env_overlay!r} — the "
                f"device slice appears invalid; not respawning"
            )
            log.error("fleet: %s circuit breaker OPEN (placement): %s", w.name, err)
            return
        uptime = now - w.started_at
        w.failures = w.failures + 1 if uptime < self.config.healthy_after_s else 1
        if w.failures >= self.config.breaker_threshold:
            w.state = WorkerState.FAILED
            log.error(
                "fleet: %s circuit breaker OPEN after %d consecutive fast "
                "failures (last rc=%s) — not restarting",
                w.name,
                w.failures,
                rc,
            )
            return
        delay = min(
            self.config.backoff_max_s,
            self.config.backoff_base_s * 2 ** (w.failures - 1),
        )
        w.restart_at = now + delay
        w.state = WorkerState.DOWN
        log.warning(
            "fleet: %s exited rc=%s after %.1fs; restart %d in %.1fs",
            w.name,
            rc,
            uptime,
            w.failures,
            delay,
        )

    # -- wire-registered membership (docs/FLEET.md "Cross-host topology") --
    def _expire_lease_locked(self, w: Worker) -> None:
        """A remote worker's lease ran out (or it wedged): this
        incarnation is dead to the fleet.  Fires the SAME migration hook
        a local process exit does, then fences the generation — a
        partitioned-but-alive worker that reconnects is refused typed,
        never silently re-admitted over its rescued sessions."""
        log.warning(
            "fleet: lease of %s gen %d expired — fencing and migrating "
            "its sessions",
            w.name,
            w.generation,
        )
        self._fence_locked(w)
        w.lease_dead = True
        w.state = WorkerState.DOWN
        w.unready = 0
        self._c_lease_expired.inc()
        obs.flight.record(
            "lease.expired", worker=w.name, generation=w.generation
        )
        if self._draining:
            return
        # a lease expiry is this tier's worker death: same recovery clock
        self.slo_engine.note_worker_exit(w.name, w.generation, time.time())
        if self.on_worker_exit is not None:
            try:
                self.on_worker_exit(w.name, w.generation)
            except Exception:  # pragma: no cover - the hook must not kill the tick
                log.exception("fleet: worker-exit hook failed for %s", w.name)

    def register_worker(self, doc: dict) -> dict:
        """Admit a wire-registered worker; ``doc`` is its startup JSON
        line (the existing contract IS the handshake).  Returns the
        grant: assigned name, fresh generation, lease TTL, heartbeat
        cadence, and — when the fleet spills remotely — the spill
        namespace this incarnation must write.

        A re-registration claiming a known remote name bumps that slot's
        generation (exactly a local respawn); if the prior generation's
        lease was still standing, it is expired first — re-registration
        is an admission that the old incarnation is gone, and its
        sessions need rescuing like any death."""
        from tpu_life_torch.fleet import errors as fl_errors
        from tpu_life_torch.fleet.membership import heartbeat_every

        url = doc.get("url")
        if not isinstance(url, str) or not url.startswith("http"):
            raise fl_errors.bad_registration(
                f"registration needs the worker's bound url, got {url!r}"
            )
        # every wire field is validated BEFORE any slot mutation: a typed
        # 400 must leave no half-registered ghost behind (a slot with a
        # bumped generation and a zero lease would fence-and-migrate an
        # incarnation that never existed)
        devices: int | None = None
        if doc.get("devices"):
            try:
                devices = int(doc["devices"])
            except (TypeError, ValueError):
                raise fl_errors.bad_registration(
                    f"registration devices must be an integer, "
                    f"got {doc['devices']!r}"
                ) from None
        with self._lock:
            if self._draining:
                raise fl_errors.no_ready_workers(len(self.workers))
            claimed = doc.get("worker")
            w = self.get(claimed) if isinstance(claimed, str) else None
            if w is not None and not w.remote:
                raise fl_errors.bad_registration(
                    f"{claimed!r} is a locally supervised worker; remote "
                    f"registration cannot claim it"
                )
            if w is None:
                # honor a well-formed unclaimed name: two workers
                # re-registering after a control-plane restart must keep
                # their DISTINCT old identities, not collide on one
                # auto-minted slot and fence each other in a ping-pong
                if isinstance(claimed, str) and re.fullmatch(r"w\d+", claimed):
                    name = claimed
                else:
                    taken = {x.name for x in self.workers}
                    idx = len(self.workers)
                    while f"w{idx}" in taken:
                        idx += 1
                    name = f"w{idx}"
                w = Worker(
                    name=name,
                    log_path=self.log_dir / f"{name}.log",
                    remote=True,
                )
                self.workers.append(w)
            else:
                if not w.lease_dead and w.url is not None:
                    self._expire_lease_locked(w)
                # a slot re-claim is the SAME worker process carrying
                # cumulative chaos counters into its next generation: its
                # fresh scrapes SUPERSEDE the old generation's retention
                # (keeping both would double-count every prior injection)
                self._injections = {
                    k: v for k, v in self._injections.items() if k[0] != w.name
                }
            w.remote = True
            w.generation += 1
            w.proc = None
            w.url = url
            w.run_id = doc.get("run_id")
            if devices is not None:
                w.devices = devices
                w.device_kind = doc.get("device_kind") or w.device_kind
            w.lease_dead = False
            w.lease_expires_at = self.clock() + self.config.lease_ttl_s
            w.started_at = self.clock()
            w.unready = 0
            w.ever_ready = False
            standby = bool(doc.get("standby"))
            if standby:
                # a pre-registered standby (docs/FLEET.md "Autoscaling"):
                # parked out of the rotation, lease kept warm by its
                # heartbeats, launched by recruit() when demand calls
                w.standby = True
                w.state = WorkerState.STANDBY
            else:
                w.standby = False
                w.state = WorkerState.STARTING
            self._c_registrations.inc()
            obs.flight.record(
                "register",
                worker=w.name,
                generation=w.generation,
                url=url,
                standby=standby,
            )
            self._update_gauges()
            grant = {
                "worker": w.name,
                "generation": w.generation,
                "lease_ttl_s": self.config.lease_ttl_s,
                "heartbeat_every_s": heartbeat_every(self.config.lease_ttl_s),
            }
            if standby:
                grant["standby"] = True
            if self.config.spill_url is not None:
                grant["spill"] = {
                    "url": self.config.spill_url,
                    "namespace": self.spill_namespace(w.name, w.generation),
                }
            log.info(
                "fleet: registered remote worker %s gen %d at %s",
                w.name,
                w.generation,
                url,
            )
            return grant

    def heartbeat(self, name: str, generation: int) -> dict:
        """Renew a remote worker's lease; the typed 410 ``lease_expired``
        for a fenced (or superseded) incarnation is the generation fence
        the split-brain guarantee rests on."""
        from tpu_life_torch.fleet import errors as fl_errors

        generation = int(generation)
        with self._lock:
            w = self.get(name)
            if w is None or not w.remote:
                raise fl_errors.unknown_worker(name)
            if (name, generation) in self._drain_fenced:
                # a drain fence, not a lease-expiry fence: the worker's
                # sessions were never rescued, so it must NOT drop them —
                # typed 503, and the refusal counter (fence evidence)
                # stays untouched
                raise fl_errors.draining(name)
            if (
                (name, generation) in self._fenced
                or w.generation != generation
                or w.lease_dead
            ):
                self._c_lease_refused.inc()
                raise fl_errors.lease_expired(name, generation)
            w.lease_expires_at = self.clock() + self.config.lease_ttl_s
            return {
                "worker": name,
                "generation": generation,
                "lease_ttl_s": self.config.lease_ttl_s,
            }

    def _fence_locked(self, w: Worker) -> None:
        """Record the generation fence for ``w``'s current incarnation
        (caller holds the lock), evicting the oldest fence past the
        :data:`MAX_FENCES` bound."""
        self._fenced[(w.name, w.generation)] = None
        obs.flight.record("fence", worker=w.name, generation=w.generation)
        while len(self._fenced) > MAX_FENCES:
            self._fenced.popitem(last=False)

    def is_fenced(self, name: str, generation: int) -> bool:
        with self._lock:
            return (name, int(generation)) in self._fenced

    def spill_namespace(self, name: str, generation: int) -> str:
        """Where one worker incarnation spills in the REMOTE store: the
        site-prefixed twin of ``worker_spill_dir`` (two fleets sharing a
        store stay disjoint by site)."""
        return f"{self.config.site}{name}g{generation}"

    # -- fleet trace collection (docs/OBSERVABILITY.md) ---------------------
    def _scrape_traces(self, targets: list[tuple]) -> None:
        """Drain each target worker's trace + flight rings concurrently
        (tick latency must be max(scrape), not sum — the probe rule)."""
        if not targets:
            return
        if len(targets) == 1:
            self._scrape_one(*targets[0])
            return
        threads = [
            threading.Thread(
                target=self._scrape_one, args=t, daemon=True
            )
            for t in targets
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _scrape_one(self, w: Worker, generation: int, url: str) -> None:
        """One best-effort drain of a worker's ``/v1/debug/trace``,
        appended as a scrape record to ``<trace_dir>/<name>.jsonl``.
        The clock offset is handshake-estimated: the worker's reported
        ``now`` against the midpoint of our request window — on one
        machine it reads ~0, across hosts it absorbs the wall-clock
        delta so the merge can place both rings on the collector clock."""
        t0 = time.time()
        try:
            req = urllib.request.Request(url + "/v1/debug/trace")
            with urllib.request.urlopen(req, timeout=2.0) as resp:
                doc = json.loads(resp.read())
        except Exception:
            return  # unreachable/dying worker: evidence stays best-effort
        t1 = time.time()
        if not isinstance(doc, dict):
            return
        events = doc.get("events") or []
        flights = doc.get("flight") or []
        if not events and not flights:
            return  # nothing new this tick: no capture line
        now = doc.get("now")
        offset = (
            float(now) - (t0 + t1) / 2.0
            if isinstance(now, (int, float))
            else 0.0
        )
        self._append_capture(
            f"{w.name}.jsonl",
            {
                "worker": w.name,
                "generation": generation,
                "pid": doc.get("pid"),
                "run_id": doc.get("run_id"),
                "wall_t0": doc.get("wall_t0"),
                "offset_s": offset,
                "scraped_at": t1,
                "dropped": doc.get("dropped", 0),
                "events": events,
                "flight": flights,
            },
        )

    def _scrape_control(self) -> None:
        """Drain THIS process's flight ring (router pins, migrations,
        the supervisor's own lifecycle verdicts) into ``control.jsonl``
        — the control plane is a process in the journey too."""
        flights = obs.flight.drain()
        if not flights:
            return
        self._append_capture(
            "control.jsonl",
            {
                "worker": "control",
                "generation": 0,
                "pid": os.getpid(),
                "run_id": None,
                "wall_t0": None,
                "offset_s": 0.0,  # the collector IS the reference clock
                "scraped_at": time.time(),
                "dropped": 0,
                "events": [],
                "flight": flights,
            },
        )

    def _scrape_series(self, targets: list[tuple]) -> None:
        """Read each target worker's snapshot ring concurrently (the
        probe rule: pass latency is max(scrape), not sum)."""
        if not targets:
            return
        if len(targets) == 1:
            self._scrape_series_one(*targets[0])
            return
        threads = [
            threading.Thread(
                target=self._scrape_series_one, args=t, daemon=True
            )
            for t in targets
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _scrape_series_one(self, w: Worker, generation: int, url: str) -> None:
        """One best-effort cursor read of a worker's
        ``/v1/debug/series``: new snapshots land in the per-(worker,
        generation) store (the SLO engine's window substrate) and — with
        ``trace_dir`` set — in ``<name>.series.jsonl`` for offline
        replay.  The cursor is per INCARNATION: a respawned worker's
        ring restarts at seq 0 under a new generation key, so a counter
        reset reads as a new series, never a negative rate."""
        key = (w.name, generation)
        cursor = self._series_cursors.get(key, 0)
        t0 = time.time()
        try:
            req = urllib.request.Request(f"{url}/v1/debug/series?cursor={cursor}")
            with urllib.request.urlopen(req, timeout=2.0) as resp:
                doc = json.loads(resp.read())
        except Exception:
            return  # unreachable/dying worker: collection stays best-effort
        if not isinstance(doc, dict):
            return
        snapshots = doc.get("snapshots") or []
        dropped = int(doc.get("dropped") or 0)
        next_cursor = doc.get("next_cursor")
        if isinstance(next_cursor, int) and next_cursor >= cursor:
            self._series_cursors[key] = next_cursor
        if not snapshots and not dropped:
            return  # nothing new this pass: no store growth, no capture line
        self.series_store.extend(w.name, generation, snapshots, dropped=dropped)
        if self.config.trace_dir is not None:
            self._append_capture(
                f"{w.name}.series.jsonl",
                {
                    "worker": w.name,
                    "generation": generation,
                    "pid": doc.get("pid"),
                    "run_id": doc.get("run_id"),
                    "scraped_at": time.time(),
                    "latency_s": round(time.time() - t0, 6),
                    "cursor": cursor,
                    "next_cursor": next_cursor,
                    "dropped": dropped,
                    "snapshots": snapshots,
                },
            )

    def _sample_control_series(self) -> None:
        """Snapshot the fleet's OWN registry (router routes, leases,
        restarts, ``watcher_shed_total`` — the control plane's signals)
        into its ring and the store under the ``control`` series."""
        snap = self._control_series.sample(self._registry)
        self.series_store.extend("control", 0, [snap])
        if self.config.trace_dir is not None:
            self._append_capture(
                "control.series.jsonl",
                {
                    "worker": "control",
                    "generation": 0,
                    "pid": os.getpid(),
                    "run_id": None,
                    "scraped_at": time.time(),
                    "cursor": snap["seq"],
                    "next_cursor": snap["seq"] + 1,
                    "dropped": 0,
                    "snapshots": [snap],
                },
            )

    def _append_capture(self, fname: str, rec: dict) -> None:
        root = Path(self.config.trace_dir)
        try:
            with self._capture_lock:
                root.mkdir(parents=True, exist_ok=True)
                with open(root / fname, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        except OSError:
            log.warning("fleet: could not append trace capture %s", fname)

    def _kill_for_recycle_locked(self, w: Worker) -> None:
        """Kill a recycle victim (startup timeout / unready threshold).
        With trace collection on and a scrapeable URL, the kill is
        DEFERRED to the tick's unlocked tail so a best-effort final
        drain of the victim's rings (the chaos-counter-scrape
        discipline: evidence leaves the process before the process
        leaves) never runs HTTP under the supervisor lock — the routing
        hot path (ready_workers/get) takes this lock on every request.
        Untraced fleets kill inline, byte-for-byte the prior behavior."""
        w.recycling = True
        if self.config.trace_dir is not None and w.url is not None:
            self._doomed.append((w, w.generation, w.url))
        else:
            w.proc.kill()

    def _reap_doomed(self) -> None:
        """The tick's unlocked tail: final-scrape each deferred recycle
        victim, then deliver its kill (re-validated under the lock — the
        generation must still be the condemned one and the process still
        alive; a self-exit meanwhile already took the _on_exit path)."""
        with self._lock:
            doomed, self._doomed = self._doomed, []
        for w, gen, url in doomed:
            self._scrape_one(w, gen, url)
            if self.config.series_every_s > 0:
                self._scrape_series_one(w, gen, url)
            with self._lock:
                if (
                    w.generation == gen
                    and w.proc is not None
                    and w.proc.poll() is None
                ):
                    w.proc.kill()

    # -- chaos-injection retention (docs/CHAOS.md) --------------------------
    def _record_injections_locked(self, w: Worker, series: dict) -> None:
        """Fold one scrape of a worker's ``chaos_injections_total`` into
        the per-(worker, generation) last-seen view.  Monotone max per
        incarnation: a counter reset (respawn) starts a NEW generation
        key instead of silently shrinking the old one."""
        totals: dict[tuple[str, str, str], float] = {}
        for key, v in series.items():
            point, _, outcome = key.partition("|")
            k = (w.name, w.generation, point, outcome)
            self._injections[k] = max(self._injections.get(k, 0.0), float(v))
        for (name, _gen, point, outcome), v in self._injections.items():
            if name == w.name:
                tk = (name, point, outcome)
                totals[tk] = totals.get(tk, 0.0) + v
        for (name, point, outcome), v in totals.items():
            self._g_injections.labels(
                worker=name, point=point, outcome=outcome
            ).set(v)

    def injection_totals(self) -> dict:
        """``point -> outcome -> count`` summed over every worker
        incarnation ever seen — the drill's exact accounting (a dead
        worker's last-seen counters are retained here, not lost with its
        registry)."""
        with self._lock:
            out: dict[str, dict[str, float]] = {}
            for (_name, _gen, point, outcome), v in self._injections.items():
                bucket = out.setdefault(point, {})
                bucket[outcome] = bucket.get(outcome, 0.0) + v
            return out

    def _spawn_worker(self, w: Worker, *, first: bool = False) -> None:
        if self._draining:
            # a SIGTERM can land between installing handlers and start()'s
            # spawn loop (the handler interleaves — the lock is reentrant
            # on this thread): a worker spawned AFTER the drain began would
            # never receive its SIGTERM and the drain would hang forever
            w.state = WorkerState.DOWN
            return
        w.generation += 1
        w.started_at = self.clock()
        w.url = None
        w.run_id = None
        w.unready = 0
        w.recycling = False
        w.state = WorkerState.STARTING
        if not first:
            self._c_restarts.inc()
        self.spawn(w)

    def _update_gauges(self) -> None:
        counts = {st: 0 for st in WorkerState}
        for w in self.workers:
            counts[w.state] += 1
            if w.devices is not None:
                self._g_devices.labels(worker=w.name).set(float(w.devices))
        for st, n in counts.items():
            self._g_workers.labels(state=st.value).set(float(n))

    # -- default process plumbing -----------------------------------------
    def worker_argv(self, w: Worker) -> list[str]:
        argv = [
            sys.executable,
            "-m",
            "tpu_life_torch",
            "gateway",
            "--host",
            self.config.host,
            "--port",
            "0",
            *self.config.worker_args,
            *w.placement_args,
        ]
        if self.config.metrics_dir is not None:
            sink = Path(self.config.metrics_dir) / f"{w.name}.jsonl"
            argv += ["--metrics-file", str(sink)]
        if self.config.spill_dir is not None:
            # per-incarnation spill dir: a respawn must never read (or
            # clobber) its predecessor's sessions — the migrator owns those
            from tpu_life_torch.fleet.migrate import worker_spill_dir

            argv += [
                "--spill-dir",
                str(worker_spill_dir(self.config.spill_dir, w.name, w.generation)),
                "--spill-every",
                str(self.config.spill_every),
            ]
        elif self.config.spill_url is not None:
            # the remote twin: same per-incarnation isolation, expressed
            # as a namespace in the shared store instead of a directory
            argv += [
                "--spill-url",
                self.config.spill_url,
                "--spill-namespace",
                self.spill_namespace(w.name, w.generation),
                "--spill-every",
                str(self.config.spill_every),
            ]
        if self.config.trace_dir is not None:
            # fleet trace collection: an ACTIVE tracer per incarnation —
            # the scrape drains its ring live, and a graceful exit writes
            # whatever was never drained to the per-generation file the
            # merge also reads (a respawn must not clobber its
            # predecessor's undrained tail)
            argv += [
                "--trace-events",
                str(
                    Path(self.config.trace_dir)
                    / f"{w.name}g{w.generation}.trace.json"
                ),
            ]
        return argv

    def _default_spawn(self, w: Worker) -> None:
        # the package may be import-from-checkout rather than installed:
        # make sure the child can `python -m tpu_life_torch` regardless of cwd
        env = dict(os.environ)
        pkg_root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = (
            pkg_root + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH")
            else pkg_root
        )
        if w.env_overlay:
            # the placement seam: this worker's device slice, re-applied
            # verbatim at every spawn so a restart re-enters the SAME env
            apply_env_overlay(env, w.env_overlay)
        w.log_offset = w.log_path.stat().st_size if w.log_path.exists() else 0
        with open(w.log_path, "ab") as logf:
            w.proc = subprocess.Popen(
                self.worker_argv(w),
                stdout=logf,
                stderr=subprocess.STDOUT,
                env=env,
                # detached session: a ^C at the fleet CLI must reach the
                # workers as a supervised drain, not a raw group SIGINT
                start_new_session=True,
            )
        log.debug("fleet: spawned %s gen %d pid %d", w.name, w.generation, w.proc.pid)

    def _read_startup(self, w: Worker) -> dict | None:
        """Scan the worker's log (from this generation's offset) for the
        gateway startup JSON line; returns the parsed line (url, run_id,
        resolved devices/device_kind, ...) or None."""
        try:
            with open(w.log_path, "rb") as f:
                f.seek(w.log_offset)
                data = f.read()
        except OSError:
            return None
        for raw in data.split(b"\n")[:-1]:  # complete lines only
            raw = raw.strip()
            if not raw.startswith(b"{"):
                continue
            try:
                doc = json.loads(raw)
            except json.JSONDecodeError:
                continue
            if doc.get("mode") == "gateway" and "url" in doc:
                return doc
        return None

    def _default_probe(self, w: Worker):
        if w.url is None:
            return "unreachable"
        try:
            req = urllib.request.Request(w.url + "/readyz")
            with urllib.request.urlopen(req, timeout=1.0) as resp:
                try:
                    doc = json.loads(resp.read())
                except (json.JSONDecodeError, OSError):
                    doc = {}
            # the injection-retention scrape (docs/CHAOS.md): while a
            # chaos plan is armed in THIS process (a drill), every probe
            # also folds the worker's chaos_injections_total into the
            # fleet registry — so a dead worker's counters no longer die
            # with its own registry, and drill accounting is exact
            # rather than a pre-kill floor
            if chaos.armed():
                series = _scrape_injection_series(w.url)
                if series:
                    doc["_chaos_injections"] = series
            # carry the readyz body: it grows devices/device_kind
            # once the worker's async device resolution lands
            return ("ready", doc)
        except urllib.error.HTTPError as e:
            if e.code == 503:
                return "draining"
            reason = _unready_reason(e)
            if reason:
                # a TYPED refusal (the serve wedge watchdog's 500
                # engine_wedged): unreachable for recycle purposes, but
                # the machine-readable reason rides along
                return ("unreachable", {"unready_reason": reason})
            return "unreachable"
        except Exception:
            return "unreachable"


def _unready_reason(e) -> str | None:
    """``code[:reason]`` from a refused probe's JSON error envelope, or
    None when the body is unreadable/untyped — reason extraction must
    never turn a readable refusal into a probe crash."""
    try:
        doc = json.loads(e.read() or b"{}")
        err = doc.get("error") or {}
        code = err.get("code")
        if not code:
            return None
        reason = err.get("reason")
        return f"{code}:{reason}" if reason else str(code)
    except Exception:
        return None


def _scrape_injection_series(url: str) -> dict[str, float] | None:
    """One best-effort scrape of a worker's ``chaos_injections_total``
    series: ``{"point|outcome": value}``, or None when the worker (or its
    exposition) is unreadable — evidence collection must never fail a
    probe that already answered ready."""
    try:
        req = urllib.request.Request(url + "/metrics")
        with urllib.request.urlopen(req, timeout=1.0) as resp:
            text = resp.read().decode()
    except Exception:
        return None
    series: dict[str, float] = {}
    for line in text.splitlines():
        if not line.startswith("chaos_injections_total{"):
            continue
        head, _, value = line.rpartition(" ")
        inner = head[head.find("{") + 1 : head.rfind("}")]
        point = outcome = ""
        for part in inner.split(","):
            k, _, v = part.partition("=")
            if k == "point":
                point = v.strip('"')
            elif k == "outcome":
                outcome = v.strip('"')
        if not point:
            continue
        try:
            series[f"{point}|{outcome}"] = float(value)
        except ValueError:
            continue
    return series or None


def worker_weight(w: Worker) -> float:
    """The capacity weight weighted-least-depth routing normalizes queue
    depth by: the worker's resolved device count (planned until its
    startup line reports), never below 1 — a worker that has not said
    what it owns routes as a single-chip peer, not as zero capacity."""
    return float(max(1, w.devices or 1))


def propagate_signals(on_signal) -> None:
    """SIGTERM / SIGINT -> the fleet-wide drain (main thread only)."""

    def _handler(signum, frame):
        log.info("fleet: signal %d — draining the fleet", signum)
        on_signal()

    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)
