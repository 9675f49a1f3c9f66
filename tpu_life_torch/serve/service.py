"""The public serving API: ``submit / poll / cancel / drain`` (the port of
``tpu_life/serve/service.py``).

What differs from the JAX package: the serve backends are the port's
(``cuda``, the default, ``numpy``, ``sharded``, ``tuned`` (resolved per
CompileKey through the autotune cache), the host backends ``stripes`` and
``native`` and the ``mesh:RxC`` tier; serve/engine.py maps them to
engines), and ``ServeConfig.device`` names the card or the CPU (the host
backends need neither).  ``spill_url`` spills through the HTTP spill
store (``serve/spill_http.py``), as in the JAX package.  Stochastic
sessions (``ising``, ``noisy:``; ``sweep`` fans a temperature grid into
them) run on ``cuda`` and ``numpy`` and are refused typed on ``sharded``
and ``mesh:RxC`` at submit, as in the JAX package.

:class:`SimulationService` is the in-process serving core — the piece of
the repo whose shape is an inference stack rather than a batch job.  A
network front-end would be a thin shell over exactly these four verbs;
the CLI's ``serve`` / ``submit`` modes are the first such shell.

Execution is cooperative: ``pump()`` runs one scheduling round,
``drain()`` pumps until idle.  Cooperative beats background threads here
for the same reason the driver is a synchronous loop: every test and
every caller sees a deterministic interleaving, and the host-sync chunk
boundary is already the natural scheduling quantum (sessions join and
leave the batch only there).

``pump()`` comes in two shapes (``ServeConfig.pipeline``):

- **pipelined** (the default): a double-buffered round in three phases —
  a locked *begin* (deadline expiry, admission, one async chunk dispatch
  per engine in rotated key order), an **unlocked** *settle* (device
  chunks and host-engine compute finish while submit/poll/cancel stay
  serviceable), and a locked *end* (retire the previous dispatches'
  finishers from the engines' double buffers, refill the freed slots,
  late-dispatch engines that sat out the begin).  The device rounds
  back-to-back: retirement and admission overlap the in-flight chunk
  instead of idling it.  Bit-identity with the synchronous pump (and
  with solo ``driver.run``) is structural — a finished slot is frozen by
  the in-scan mask, so *when* the host reads it cannot change *what* it
  reads — and the equivalence suites assert it.
- **sync** (``pipeline=False``): the classic host-synchronous round
  (admit -> step -> retire under one lock hold) — the oracle shape, and
  the baseline leg of ``bench.py --serve-pipeline``.

The verbs are thread-safe: one internal lock serializes ``submit`` /
``poll`` / ``result`` / ``cancel`` / ``stats`` against the pump's locked
phases, so a network front-end (``tpu_life_torch.gateway``) can run ONE
background pump thread that owns all device work while handler threads
call the verbs concurrently — the engine's one-compile-per-CompileKey
invariant never meets a second pumping thread, and under the pipelined
pump a verb is never blocked behind device compute (a separate pump
mutex keeps a second pumping thread out of the phase machine without
making it wait on device work either).  ``begin_drain()`` is the
shutdown hook: it closes admission (``submit`` raises :class:`Draining`)
while in-flight sessions keep stepping to completion; the pipelined
drain retires every in-flight chunk before ``idle()`` reports true.

Observability rides the unified obs layer (docs/OBSERVABILITY.md): the
service generates one ``run_id``, every pump emits a ``MetricsRecorder``
record (queue depth, batch occupancy, sessions/sec, live queue-wait /
completion-latency quantiles), a labeled registry tracks the counters and
histograms behind those quantiles (exported to the JSONL sink at close
and to ``--prom-file`` as a Prometheus snapshot), ``--trace-events``
brackets every scheduling round with admit / step-chunk / retire spans
plus per-session async queue-wait intervals, and ``drain`` still runs
under ``runtime.profiling.maybe_profile`` so a device trace lands in the
same tooling as a batch run.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from tpu_life_torch import chaos, obs
from tpu_life_torch.models.rules import Rule, get_rule
from tpu_life_torch.runtime import recovery
from tpu_life_torch.runtime.checkpoint import atomic_publish as ckpt_atomic_publish
from tpu_life_torch.runtime.metrics import MetricsRecorder, log
from tpu_life_torch.runtime.profiling import maybe_profile
from tpu_life_torch.serve.engine import CompileKey, compile_key_for
from tpu_life_torch.serve.errors import (
    Draining,
    InsufficientMemory,
    QueueFull,
    QuotaExceeded,
)
from tpu_life_torch.serve.qos import QosPolicy, tenant_label
from tpu_life_torch.serve.scheduler import RoundStats, Scheduler
from tpu_life_torch.serve.stream import (
    StreamHub,
    estimate_stream_bytes,
    parse_edit_log,
    render_edit_log,
    validate_cells,
)
from tpu_life_torch.serve.sessions import (
    SessionState,
    SessionStore,
    SessionView,
    TERMINAL,
)


@dataclass
class ServeConfig:
    capacity: int = 8  # batch slots per compile key
    chunk_steps: int = 16  # device steps per scheduling round
    max_queue: int = 64  # bounded admission queue (backpressure)
    backend: str = "cuda"  # engine executor: cuda | torch | numpy | sharded
    # the device of the device engines: None the current card, "cpu" the
    # plain PyTorch versions on the host (the tests' device)
    device: str | None = None
    # the pipelined (double-buffered) pump; False = the host-synchronous
    # round, kept as the bit-identity oracle and the bench baseline
    pipeline: bool = True
    default_timeout_s: float | None = None  # per-request deadline default
    metrics: bool = False  # record per-pump serve metrics
    metrics_file: str | None = None  # JSONL sink (implies metrics)
    profile: str | None = None  # torch.profiler trace dir for drain()
    # Chrome trace-event JSON (Perfetto): round spans + per-session
    # queue-wait intervals, correlated with metrics records via run_id
    trace_events: str | None = None
    prom_file: str | None = None  # Prometheus text snapshot, written at close
    run_id: str | None = None  # correlation id (generated when unset)
    # durable sessions (docs/SERVING.md "durability"): when set, every
    # ``spill_every`` rounds each live session's board + manifest is
    # spilled to <spill_dir>/<sid>/ through the crash-consistent
    # checkpoint contract, so a supervisor can resume a SIGKILLed
    # worker's sessions on a survivor (docs/FLEET.md failover).  The
    # spill write runs off the pipelined pump's unlocked settle window —
    # it never blocks submit/poll/cancel.
    spill_dir: str | None = None
    spill_every: int = 4  # rounds between spill passes
    # the remote spill backend (docs/FLEET.md "Cross-host topology"):
    # instead of a local directory, spill through an HTTP spill store
    # (``tpu-life spill-store``) under ``spill_namespace`` — the same
    # atomic-publish + CRC contract on the wire, so a migrator on
    # ANOTHER machine can read the rescue.  Mutually exclusive with
    # ``spill_dir`` (typed error at construction).
    spill_url: str | None = None
    spill_namespace: str | None = None  # default: this service's run_id
    # replicated local spill (docs/FLEET.md): > 1 fans every spill write
    # through N replica sub-stores under spill_dir (reads-any with
    # demotion on the rescue path); 1 = the plain single store
    spill_replicas: int = 1
    # the stochastic tier's bitplane knob (docs/STOCHASTIC.md packed
    # tier): ising batches run on the bitplane-packed device engine (32
    # spins per uint32 lane, bit-identical to the roll path).  False
    # (--no-bitpack) pins the int8 roll engines — the oracle
    # configuration the packed path is byte-compared against in CI.
    mc_packed: bool = True
    # the neighborhood-counting path (--stencil, docs/RULES.md): "roll"
    # shift-adds, "matmul" banded matmuls (bit-identical for integer
    # rules, the MXU path for large radii and the continuous tier), or
    # "auto" — the measured crossover model per rule, with the numpy
    # executor pinned to roll so the oracle never silently moves.
    # Resolved per CompileKey at submit (ops.conv.resolve_stencil).
    stencil: str = "auto"
    # the resource governor (docs/SERVING.md "Resource governance"):
    # admission-time memory budget for the estimated engine footprint.
    # None derives devices x per-kind default from device_info(); <= 0
    # disables accounting.  A submit whose CompileKey would overflow it
    # raises the typed InsufficientMemory instead of letting the card OOM
    # kill the worker mid-round.
    memory_budget_bytes: int | None = None
    # in-place recovery budget per CompileKey: chunk-level RECOVERABLE
    # faults are masked by rebuild-and-replay (an OOM halves the chunk;
    # a second demotes the key to the host) this many times before falling
    # back to the typed per-key failure.  0 = pure failure isolation.
    engine_max_restarts: int = 3
    # the wedge watchdog: a pipelined settle window still blocked after
    # this many seconds marks the service WEDGED — finishers of already-
    # settled engines are salvaged and /readyz flips to 500 with a
    # machine-readable reason, so a fleet supervisor's unready-recycle +
    # migration path rescues the sessions.  None disables the watchdog.
    settle_deadline_s: float | None = None
    # time-series retention (docs/OBSERVABILITY.md "Time series"): the
    # pump's retire tail snapshots the registry into a bounded ring at
    # most once per series_every_s, scraped non-destructively through
    # GET /v1/debug/series?cursor=.  0 disables the ring entirely — the
    # hot path then pays one is-None check and nothing else.
    series_every_s: float = 1.0
    series_max_snapshots: int = 512
    # tenant QoS (docs/SERVING.md "Tenant QoS"): the declarative
    # per-tenant policy — identity, quotas, DRR weights, shed tiers.
    # None (the default) keeps the whole stack tenant-blind: no quota
    # checks, FIFO admission, zero per-tenant label cardinality.
    qos: QosPolicy | None = None
    # the mega-board mesh tier (docs/SERVING.md "Mega-board sessions"):
    # the device count of the slice reserved for sessions whose governor
    # verdict is "never fits on one chip".  0 disables the tier — those
    # sessions stay a typed 413 (now carrying the mesh_eligible hint).
    # When > 0, a never-fits deterministic/continuous session is
    # converted at submit into a ``mesh:RxC`` CompileKey (shape from
    # ``serve.mesh_engine.plan_mesh_shape``) and runs capacity-1 on the
    # sharded halo-exchange backend, coexisting with batched small
    # sessions on the remaining capacity.
    mesh_devices: int = 0


class SimulationService:
    def __init__(self, config: ServeConfig | None = None, *, clock=time.monotonic):
        self.config = config or ServeConfig()
        if self.config.max_queue < 1:
            # a zero-length queue can never admit anything: every submit
            # would bounce and a retry-on-QueueFull client would spin
            raise ValueError(
                f"max_queue must be >= 1, got {self.config.max_queue}"
            )
        # fail at construction, not at the first admission's lazy engine
        # build (EngineBase re-checks, but by then sessions are queued)
        if self.config.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.config.capacity}")
        if self.config.chunk_steps < 1:
            raise ValueError(
                f"chunk_steps must be >= 1, got {self.config.chunk_steps}"
            )
        if (
            self.config.spill_dir is not None
            or self.config.spill_url is not None
        ) and self.config.spill_every < 1:
            raise ValueError(
                f"spill_every must be >= 1, got {self.config.spill_every}"
            )
        if self.config.engine_max_restarts < 0:
            raise ValueError(
                f"engine_max_restarts must be >= 0, "
                f"got {self.config.engine_max_restarts}"
            )
        if (
            self.config.settle_deadline_s is not None
            and self.config.settle_deadline_s <= 0
        ):
            raise ValueError(
                f"settle_deadline_s must be > 0, "
                f"got {self.config.settle_deadline_s}"
            )
        if self.config.series_every_s < 0:
            raise ValueError(
                f"series_every_s must be >= 0 (0 disables sampling), "
                f"got {self.config.series_every_s}"
            )
        if self.config.series_every_s > 0 and self.config.series_max_snapshots < 1:
            raise ValueError(
                f"series_max_snapshots must be >= 1, "
                f"got {self.config.series_max_snapshots}"
            )
        if self.config.mesh_devices < 0:
            raise ValueError(
                f"mesh_devices must be >= 0 (0 disables the mesh tier), "
                f"got {self.config.mesh_devices}"
            )
        from tpu_life_torch.ops.conv import validate_stencil
        from tpu_life_torch.serve.engine import HOST_BACKENDS, check_backend

        validate_stencil(self.config.stencil)
        check_backend(self.config.backend)
        if self.config.backend not in HOST_BACKENDS or self.config.mesh_devices:
            from tpu_life_torch.backends.base import resolve_device

            # no card: the tidy error `run` gives, before anything is queued
            # (``device="cpu"`` asks for the plain versions on the host)
            resolve_device(self.config.device)
        self.clock = clock
        self.run_id = self.config.run_id or obs.new_run_id()
        self.store = SessionStore()
        self.scheduler = Scheduler(
            capacity=self.config.capacity,
            chunk_steps=self.config.chunk_steps,
            max_queue=self.config.max_queue,
            mc_packed=self.config.mc_packed,
            qos=self.config.qos,
            engine_max_restarts=self.config.engine_max_restarts,
            clock=clock,
            observer=self,
            device=self.config.device,
        )
        # the resource governor (docs/SERVING.md "Resource governance"):
        # the effective budget is resolved ONCE — the derived default
        # runs a bounded device probe, memoized process-wide — so submit
        # pays pure arithmetic
        from tpu_life_torch.serve import governor

        self._governor = governor
        self._memory_budget = governor.resolve_budget(
            self.config.memory_budget_bytes, device=self.config.device
        )
        self.registry = obs.MetricsRegistry()
        self.recorder = MetricsRecorder(
            0,
            self.config.metrics,
            sink=self.config.metrics_file,
            run_id=self.run_id,
            registry=self.registry,
        )
        # the serve instrument set (docs/OBSERVABILITY.md): queue pressure,
        # batch health, admission outcomes, and the two latency
        # distributions a multi-tenant service is judged by
        self._g_queue_depth = self.registry.gauge(
            "serve_queue_depth", "sessions waiting for a batch slot"
        )
        # head-of-line demand (docs/OBSERVABILITY.md "Time series"):
        # depth says how many wait, age says how badly we're behind —
        # the pair the autoscaler's input contract needs
        self._g_queue_age = self.registry.gauge(
            "serve_queue_age_oldest_seconds",
            "wall age of the oldest still-queued session",
        )
        self._g_occupancy = self.registry.gauge(
            "serve_batch_occupancy", "occupied slot fraction at the last step"
        )
        self._c_submitted = self.registry.counter(
            "serve_sessions_submitted_total", "sessions accepted by submit()"
        )
        self._c_rejections = self.registry.counter(
            "serve_admission_rejections_total",
            "submissions bounced by backpressure (queue full, or transient "
            "memory pressure from the governor)",
        )
        # liveness for file scrapers: a stalled pump shows as a frozen
        # round counter even while every gauge legitimately sits still
        self._c_rounds = self.registry.counter(
            "serve_rounds_total", "scheduling rounds executed"
        )
        # step throughput as registry counters (not just the per-round
        # record's plain ints): the sampled time series and `tpu-life
        # top` derive steps/s and the packed fraction from these
        self._c_steps = self.registry.counter(
            "serve_steps_total", "device steps advanced across all sessions"
        )
        self._c_steps_packed = self.registry.counter(
            "serve_packed_steps_total",
            "the slice of serve_steps_total run by bitplane-packed engines",
        )
        self._c_finished = self.registry.counter(
            "serve_sessions_finished_total",
            "sessions reaching a terminal state, by outcome",
            labels=("state",),
        )
        self._h_queue_wait = self.registry.histogram(
            "serve_queue_wait_seconds", "submit-to-admission wait"
        )
        self._h_latency = self.registry.histogram(
            "serve_completion_seconds", "submit-to-terminal-state latency"
        )
        # the overlap instruments: how many chunks are in flight
        # after dispatch (0 = host-synchronous), and how long engines sat
        # with nothing in flight between a collect and the next dispatch —
        # the seconds the pipelined pump exists to reclaim
        self._g_pipeline_depth = self.registry.gauge(
            "serve_pipeline_depth",
            "device chunks in flight after the round's dispatch phase",
        )
        self._c_device_idle = self.registry.counter(
            "serve_device_idle_seconds_total",
            "wall seconds engines had no chunk in flight between dispatches",
        )
        # the durability instruments (docs/SERVING.md): how long each
        # spill pass takes (the failover overhead being paid) and how many
        # sessions currently have a resumable spill on disk
        self._h_snapshot = self.registry.histogram(
            "serve_snapshot_seconds", "wall seconds per session-spill pass"
        )
        self._g_spilled = self.registry.gauge(
            "serve_spilled_sessions", "live sessions with a spill on disk"
        )
        # disk-full graceful degradation (docs/CHAOS.md): spill writes
        # that failed (ENOSPC, dead disk).  Each failure disables spill
        # for THAT session only — it keeps running without durability —
        # and the pump survives; the counter is the operator's signal
        self._c_spill_errors = self.registry.counter(
            "serve_spill_errors_total",
            "failed session-spill writes (the session degrades to "
            "spill-disabled; the service keeps serving)",
        )
        # engine compile counts by CompileKey bucket (rule:HxW:backend —
        # a closed set in any sane deployment; the cap bounds the rest)
        self._g_compiles = self.registry.gauge(
            "serve_engine_compile_count",
            "compiled batch programs per engine",
            labels=("compile_key",),
        )
        # the resource-governor instruments (docs/SERVING.md "Resource
        # governance"): the admission budget, the per-key estimated
        # engine footprint it is charged against, every typed admission
        # rejection by reason, and every in-place engine recovery by
        # ladder outcome
        self._g_mem_budget = self.registry.gauge(
            "serve_memory_budget_bytes",
            "admission-time memory budget for estimated engine footprints "
            "(0 = accounting disabled)",
        )
        self._g_est_bytes = self.registry.gauge(
            "serve_estimated_bytes",
            "estimated resident bytes per live engine",
            labels=("key",),
        )
        self._c_adm_rejected = self.registry.counter(
            "serve_admission_rejected_total",
            "typed admission rejections by reason",
            labels=("reason",),
        )
        self._c_recoveries = self.registry.counter(
            "serve_engine_recoveries_total",
            "in-place engine recoveries by outcome (replayed / "
            "oom_halved_chunk / oom_host_demoted / budget_exhausted / "
            "rebuild_failed / wedged)",
            labels=("outcome",),
        )
        # the stencil-path gauge (docs/RULES.md / OBSERVABILITY.md): how
        # many live CompileKeys compiled the banded-matmul counting path
        # — merged across the fleet by `tpu-life stats` like the packed
        # attribution was
        self._g_matmul_keys = self.registry.gauge(
            "serve_matmul_keys",
            "live engines whose CompileKey compiled the matmul stencil",
        )
        self._g_matmul_keys.labels()
        # the mega-board mesh tier (docs/SERVING.md "Mega-board
        # sessions"): how many live sessions run sharded over a mesh
        # slice, and the governor's per-shard estimator rows — one gauge
        # sample per (key bucket, shard) so an operator sees exactly
        # what each device of the slice is charged with
        self._g_mesh_sessions = self.registry.gauge(
            "serve_mesh_sessions",
            "live sessions sharded over the reserved mesh slice",
        )
        self._g_mesh_sessions.labels()
        self._g_mesh_est_bytes = self.registry.gauge(
            "serve_mesh_estimated_bytes",
            "estimated resident bytes per mesh shard of a live mega-board "
            "engine",
            labels=("key", "shard"),
        )
        # (key bucket, shard) pairs last set (zeroed when the engine goes)
        self._mesh_est_buckets: set[tuple[str, str]] = set()
        # tenant QoS observability (docs/SERVING.md "Tenant QoS"): live
        # sessions per tenant, and every typed per-tenant shed / quota
        # rejection by reason.  Label cardinality is bounded by the
        # policy (unknown keys collapse into one default tenant; long
        # names hash through tenant_label), and a policy-less service
        # never mints a single series.
        self._qos = self.config.qos
        self._g_tenant_sessions = self.registry.gauge(
            "serve_tenant_sessions",
            "live sessions per tenant",
            labels=("tenant",),
        )
        self._c_tenant_shed = self.registry.counter(
            "tenant_shed_total",
            "typed per-tenant sheds and quota rejections by reason "
            "(quota_sessions / quota_bytes / quota_watchers / "
            "shed_best_effort)",
            labels=("tenant", "reason"),
        )
        # tenant label buckets last set (stale buckets zero out, the
        # _est_buckets discipline)
        self._tenant_buckets: set[str] = set()
        # the span-ring loss counter (docs/OBSERVABILITY.md "Distributed
        # tracing"): events evicted from the bounded trace buffer between
        # scrapes — a nonzero value tells the doctor a journey may have
        # holes that are collection loss, not anomalies
        self._c_trace_dropped = self.registry.counter(
            "trace_spans_dropped_total",
            "trace events evicted from the bounded span ring before any "
            "scrape or write could collect them",
        )
        self._c_trace_dropped.labels()
        self._trace_dropped_seen = 0
        # the live-stream tier (docs/STREAMING.md): per-session delta
        # rings between the pump's retire phase and the watcher sockets.
        # The hub has its OWN lock — the pump appends bounded frames
        # under it, handler threads block in read() on it, and neither
        # ever holds the service lock across a socket
        self.hub = StreamHub()
        # governor charge per streamed sid (docs/SERVING.md "Resource
        # governance"): the first watcher of a session reserves its delta
        # ring's estimated bytes against the admission budget
        self._stream_charged: dict[str, int] = {}
        self._g_stream_watchers = self.registry.gauge(
            "stream_watchers", "live stream subscriptions on this worker"
        )
        self._c_stream_frames = self.registry.counter(
            "stream_frames_total", "delta-stream frames produced"
        )
        self._c_stream_gaps = self.registry.counter(
            "stream_frame_gaps_total",
            "frames dropped from bounded delta rings (slow readers resync "
            "through a typed frame_gap marker; the pump never stalls)",
        )
        for fam in (
            self._g_stream_watchers,
            self._c_stream_frames,
            self._c_stream_gaps,
        ):
            fam.labels()
        # mirror floors: the hub's plain-int totals folded into the
        # registry as monotone deltas each round (the trace_dropped
        # pattern)
        self._stream_frames_seen = 0
        self._stream_gaps_seen = 0
        self._g_mem_budget.set(float(self._memory_budget or 0))
        # key buckets whose estimated-bytes gauge was last set (released
        # engines' buckets zero out in the next round's sweep)
        self._est_buckets: set[str] = set()
        # prime the unlabeled series so a snapshot taken before the first
        # event still shows them (a zero rejection counter is information;
        # an absent one is a question)
        for fam in (
            self._g_queue_depth,
            self._g_queue_age,
            self._g_occupancy,
            self._c_submitted,
            self._c_rejections,
            self._c_rounds,
            self._c_steps,
            self._c_steps_packed,
            self._h_queue_wait,
            self._h_latency,
            self._g_pipeline_depth,
            self._c_device_idle,
            self._h_snapshot,
            self._g_spilled,
            self._c_spill_errors,
        ):
            fam.labels()
        # chaos observability (docs/CHAOS.md): injections fired in this
        # process land in the shared registry — /metrics, the prom file,
        # the JSONL snapshot.  A disarmed process just never ticks it.
        chaos.bind_registry(self.registry)
        # the spill backend (durable sessions): created eagerly so a bad
        # spill path — or a spill_dir/spill_url conflict — fails at
        # construction, not at the first spill pass.  The seam is
        # serve.spill.SpillBackend: local directory by default, the
        # remote HTTP store when spill_url is set (cross-host failover)
        if self.config.spill_dir is not None or self.config.spill_url is not None:
            from tpu_life_torch.serve.spill import SpillBackend, make_spill_backend

            self._spill: SpillBackend | None = make_spill_backend(
                spill_dir=self.config.spill_dir,
                spill_url=self.config.spill_url,
                namespace=self.config.spill_namespace or self.run_id,
                replicas=self.config.spill_replicas,
            )
        else:
            self._spill = None
        self._rounds_since_spill = 0
        # count of admitted spill-urgent sessions (spill-on-adopt) that
        # may still be awaiting their first write: lets off-cadence
        # rounds skip the full slot walk in the steady state.  May
        # overcount (self-healing: any urgent-pending walk recomputes
        # it); never undercounts while a session is still urgent.
        self._spill_urgent_pending = 0
        self._snapshot_s_total = 0.0
        # the service OWNS its tracer rather than claiming the process-
        # global slot: emissions are routed through obs.activate() per
        # round, so a concurrently traced driver.run (or second service)
        # in the same process cannot steal this service's events — every
        # span lands in the file carrying its own run_id.  With no tracer
        # of our own, activate() is a no-op and emissions join whatever
        # ambient tracer is active (an untraced service inside a traced
        # driver contributes to the driver's timeline).
        self._tracer = (
            obs.Tracer(self.config.trace_events, run_id=self.run_id)
            if self.config.trace_events
            else None
        )
        self._t0 = clock()
        # time-series retention (docs/OBSERVABILITY.md "Time series"):
        # None when disabled, so the retire tail's only cost is one
        # attribute check — the tracer's one-global-check discipline,
        # pinned by the sample_count() probe in the overhead guard
        self._series = (
            obs.timeseries.SeriesRing(self.config.series_max_snapshots)
            if self.config.series_every_s > 0
            else None
        )
        self._series_next = 0.0  # monotonic deadline of the next sample
        self._completed = 0
        self._rounds = 0
        self._occupancy_sum = 0.0  # for mean batch occupancy in stats()
        # cumulative step attribution by storage path (obs): total steps
        # advanced, and the slice run by bitplane-packed engines
        self._steps_total = 0
        self._steps_packed_total = 0
        # the thread-safe seam: every verb and the pump serialize on this
        # (reentrant: cancel/pump call observer hooks while holding it)
        self._lock = threading.RLock()
        # pump exclusivity for the pipelined path: the round spans an
        # unlocked settle window, so a second pumping thread must queue at
        # the round boundary, never interleave phases
        self._pump_mutex = threading.Lock()
        self._draining = False
        # the wedge watchdog (docs/SERVING.md "Resource governance"): a
        # settle window that blocks past settle_deadline_s is the hang
        # mode recovery cannot catch in-process (nothing raises).  The
        # watchdog thread detects it FROM OUTSIDE the pump: the pump
        # publishes (start time, plan, settled-so-far) around every
        # unlocked settle window; on deadline the watchdog — under the
        # service lock, which the stuck pump does NOT hold — marks the
        # service wedged, salvages the already-settled engines' pending
        # finishers, and /readyz answers 500 with the machine-readable
        # reason so a supervisor's unready-recycle + migration rescues
        # the rest.  Sticky by design: a declared wedge means the
        # deadline contract was broken; the recycle path owns recovery.
        self._wedged: dict | None = None
        self._settle_state: tuple | None = None
        self._watchdog_stop = threading.Event()
        self._watchdog: threading.Thread | None = None
        if self.config.settle_deadline_s is not None:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="serve-watchdog", daemon=True
            )
            self._watchdog.start()

    # -- the four verbs ----------------------------------------------------
    def submit(
        self,
        board: np.ndarray,
        rule: Rule | str,
        steps: int,
        *,
        timeout_s: float | None = None,
        fault_at: int = 0,
        seed: int | None = None,
        temperature: float | None = None,
        start_step: int = 0,
        trace_id: str | None = None,
        edits=None,
        scheduled_edits=None,
        stream_seq: int = 0,
        mesh_resume_dir: str | None = None,
        tenant: str | None = None,
    ) -> str:
        """Admit one simulation request; returns its session id.

        ``tenant`` is the resolved tenant name (docs/SERVING.md "Tenant
        QoS") the gateway derived from ``X-API-Key`` through the
        :class:`~tpu_life_torch.serve.qos.QosPolicy`.  With a configured
        policy the tenant's declared quotas are enforced here — typed
        :class:`QuotaExceeded` BEFORE anything is stored, the QueueFull
        discipline — and the admission scan orders the queue by
        deficit-round-robin over tenants.  None (the library default)
        admits tenant-blind, exactly as before.

        ``mesh_resume_dir`` is the shard-wise mega-board resume pointer
        (docs/SERVING.md "Mega-board sessions"): a spilled tile-set
        directory on a shared filesystem.  ``board`` is then only a
        geometry-carrying placeholder — the session re-gathers tile by
        tile at admission through ``MeshEngine.load_tiles`` (possibly
        onto a different mesh shape than the one that spilled), so the
        full board is never materialized on this host.  Requires a
        configured mesh slice (``mesh_devices >= 2``).

        ``edits`` / ``scheduled_edits`` / ``stream_seq`` are the steered-
        session resume fields (docs/STREAMING.md): ``edits`` is a prior
        life's APPLIED edit log (``[[step, [[r, c, v], ...]], ...]``,
        every step <= start_step — already baked into ``board``, carried
        for provenance), ``scheduled_edits`` its not-yet-applied tail
        (start_step <= step < start_step + total steps — re-applied at
        exactly the recorded steps during re-execution, which is what
        extends the bit-reproducibility contract to edited sessions),
        and ``stream_seq`` the frames a prior life already streamed, so
        the survivor's hub continues the same gapless sequence space.

        ``trace_id`` is the distributed-trace context
        (docs/OBSERVABILITY.md "Distributed tracing"): the id naming this
        session's whole cross-process journey, stamped onto every span
        and flight event that touches it and persisted in the spill
        manifest so a migrated resume CONTINUES the same trace.  The
        gateway passes the client's ``X-Trace-Id`` (or the router's
        minted one); None — the library default — adds no context and
        costs nothing.

        Validates exactly what the driver validates (2-D int8 board, every
        state within the rule's range, non-negative budget) and raises
        :class:`QueueFull` when the bounded queue is at capacity — the
        request is rejected before anything is stored, so backpressure
        bounds memory, not just slots.  After :meth:`begin_drain` every
        submit raises :class:`Draining` instead (admission is closed).

        Stochastic rules (``tpu_life_torch.mc``): ``seed`` names the
        counter-based PRNG stream (default 0) and ``temperature`` is the
        per-session ising scalar — both ride in the batch slot, not the
        CompileKey, so a mixed-temperature sweep shares one compiled
        program.  A temperature on a non-ising rule, or a stochastic rule
        on an executor without the key schedule, is a typed rejection
        here — before anything is stored.

        ``start_step`` is the failover-resume field (docs/FLEET.md): the
        absolute steps a previous life of this trajectory already
        completed.  ``board`` is that life's last snapshot, ``steps`` the
        REMAINING budget; views report absolute progress and the MC
        engines re-enter the PRNG stream at ``start_step`` — so
        resume-then-finish equals the uninterrupted run bit-for-bit.
        """
        if isinstance(rule, str):
            rule = get_rule(rule)
        from tpu_life_torch import mc
        from tpu_life_torch.serve.engine import require_float_path

        mc.validate_params(rule, temperature)
        if rule.stochastic:
            # serve backends are always explicit (no "auto"), so the hard
            # gate applies directly — rejected before anything is stored
            mc.require_key_schedule(rule, self.config.backend)
            if seed is None:
                seed = 0
        if seed is not None:
            seed = int(seed)
        if rule.continuous:
            # the continuous tier (models/lenia.py): float32 boards in
            # [0, 1], finite — and only on the float executors
            from tpu_life_torch.models import lenia

            require_float_path(rule, self.config.backend)
            board = lenia.validate_board(board, rule)
        else:
            # validate BEFORE the int8 cast: a wider-dtype caller array
            # with state 256 would wrap to 0 and sail through a post-cast
            # check — simulated junk, not a rejection
            board = np.asarray(board)
            if board.ndim != 2:
                raise ValueError(f"board must be 2-D, got shape {board.shape}")
            max_state = int(board.max(initial=0))
            if max_state >= rule.states:
                raise ValueError(
                    f"board contains state {max_state} but rule {rule.name!r} "
                    f"has only {rule.states} states (0..{rule.states - 1})"
                )
            min_state = int(board.min(initial=0))
            if min_state < 0:
                # the driver's file codec cannot produce negatives, but a
                # library caller's array can — reject rather than simulate junk
                raise ValueError(
                    f"board contains negative state {min_state}; states are "
                    f"0..{rule.states - 1}"
                )
            board = board.astype(np.int8)
        # kernel-vs-board geometry (docs/RULES.md): a kernel wider than
        # the board is a typed rejection at every admission front
        from tpu_life_torch.models.rules import validate_rule_geometry

        validate_rule_geometry(rule, board.shape)
        # board-area admission check against the PRNG counter width: the
        # packed engine carries the wide two-word cell index; the roll
        # engines are pinned narrow, so over-2^32-cell boards on them are
        # a typed rejection here, never a silent counter wraparound
        mc.validate_board_shape(
            rule,
            board.shape,
            wide_counter=mc.wide_counter_capable(
                rule, self.config.backend, bitpack=self.config.mc_packed
            ),
        )
        if steps < 0:
            raise ValueError(f"steps must be >= 0, got {steps}")
        start_step = int(start_step)
        if start_step < 0:
            raise ValueError(f"start_step must be >= 0, got {start_step}")
        stream_seq = int(stream_seq)
        if stream_seq < 0:
            raise ValueError(f"stream_seq must be >= 0, got {stream_seq}")
        # the steered-session resume logs: validated against THIS board's
        # geometry and rule before anything is stored
        edit_history = []
        for step, cells in parse_edit_log(edits if edits is not None else []):
            if step > start_step:
                raise ValueError(
                    f"applied edit at step {step} is past start_step "
                    f"{start_step}; unapplied edits belong in "
                    f"'scheduled_edits'"
                )
            edit_history.append((step, validate_cells(cells, board.shape, rule)))
        edit_scheduled = []
        for step, cells in parse_edit_log(
            scheduled_edits if scheduled_edits is not None else []
        ):
            if not start_step <= step < start_step + steps:
                raise ValueError(
                    f"scheduled edit at step {step} is outside this "
                    f"session's run [{start_step}, {start_step + steps})"
                )
            edit_scheduled.append(
                (step, validate_cells(cells, board.shape, rule))
            )
        # the mega-board mesh tier's resume pointer: validated against
        # the tile-set manifest BEFORE anything is stored, and minting
        # the session's mesh placement up front so the governor check
        # below runs against the mesh key
        mesh_shape: tuple[int, int] | None = None
        mesh_resume_rec = None
        if mesh_resume_dir is not None:
            mesh_resume_rec, mesh_shape = self._open_mesh_resume(
                mesh_resume_dir, rule, board.shape, steps, start_step
            )
        # admission is a read-modify-write on the queue: everything from the
        # backpressure check to the enqueue happens under the lock, so two
        # racing submits can neither both squeeze past a full queue nor
        # interleave with a pump's admit scan
        with self._lock:
            if self._draining:
                raise Draining(
                    "service is draining: no new sessions are admitted"
                )
            # tenant quotas (docs/SERVING.md "Tenant QoS"): the tenant's
            # own declared ceilings, checked before anything is stored.
            # A quota breach is the TENANT's limit, not service overload
            # — it stays out of the backpressure rejection counter and
            # lands in the per-tenant shed counter instead.
            if self._qos is not None and tenant is not None:
                spec = self._qos.spec(tenant)
                mine = self.store.live_by_tenant().get(tenant, 0)
                if (
                    spec.max_sessions is not None
                    and mine >= spec.max_sessions
                ):
                    self._quota_reject(tenant, "quota_sessions", trace_id)
                    raise QuotaExceeded(
                        f"tenant {tenant!r} already has {mine} live "
                        f"sessions; its max_sessions quota is "
                        f"{spec.max_sessions}",
                        tenant=tenant,
                        quota="max_sessions",
                        limit=spec.max_sessions,
                    )
                if (
                    spec.memory_fraction is not None
                    and self._memory_budget is not None
                ):
                    # the tenant's slice of the governor budget, charged
                    # per session at this session's engine estimate over
                    # capacity (a slot's share of its batch)
                    if mesh_shape is not None:
                        qkey = self._mesh_key(rule, board, mesh_shape)
                    else:
                        from tpu_life_torch.ops.conv import resolve_stencil

                        qkey = compile_key_for(
                            rule,
                            board,
                            self.config.backend,
                            resolve_stencil(
                                rule, self.config.stencil, self.config.backend
                            ),
                        )
                    per = self._governor.estimate_engine_bytes(
                        qkey,
                        self.config.capacity,
                        mc_packed=self.config.mc_packed,
                    ) / max(1, self.config.capacity)
                    slice_bytes = spec.memory_fraction * self._memory_budget
                    if per * (mine + 1) > slice_bytes:
                        self._quota_reject(tenant, "quota_bytes", trace_id)
                        raise QuotaExceeded(
                            f"tenant {tenant!r} would hold "
                            f"~{int(per * (mine + 1))} estimated bytes; "
                            f"its budget slice is {int(slice_bytes)} "
                            f"({spec.memory_fraction:g} of "
                            f"{self._memory_budget})",
                            tenant=tenant,
                            quota="memory_fraction",
                            limit=int(slice_bytes),
                        )
            # the memory governor (docs/SERVING.md "Resource governance"):
            # would this session's CompileKey overflow the budget?  An
            # existing (or already-queued) key admits for free; a new key
            # must fit next to every reserved one.  Checked BEFORE the
            # session exists anywhere, so a device out-of-memory
            # becomes a typed rejection instead of a dead worker.
            if self._memory_budget is not None:
                if mesh_shape is not None:
                    key = self._mesh_key(rule, board, mesh_shape)
                else:
                    from tpu_life_torch.ops.conv import resolve_stencil

                    key = compile_key_for(
                        rule,
                        board,
                        self.config.backend,
                        resolve_stencil(
                            rule, self.config.stencil, self.config.backend
                        ),
                    )
                sched = self.scheduler
                reserved = self._governor.reserved_bytes(
                    sched.engines,
                    (self._keyer()(s) for s in sched.queue),
                    self.config.capacity,
                    mc_packed=self.config.mc_packed,
                )

                def _record_reject(e: InsufficientMemory) -> None:
                    if e.transient:
                        # transient pressure IS backpressure: it joins
                        # the classic rejection counter so the stats
                        # rejection_rate (the first overload signal)
                        # covers it; a never-fits session is a client
                        # error, not overload, and stays out
                        self._c_rejections.inc()
                    reason = (
                        "insufficient_memory"
                        if e.transient
                        else "session_too_large"
                    )
                    self._c_adm_rejected.labels(reason=reason).inc()
                    obs.flight.record(
                        "rejection", reason=reason, trace_id=trace_id
                    )

                try:
                    self._governor.check_admission(
                        key,
                        reserved,
                        self._memory_budget,
                        self.config.capacity,
                        mc_packed=self.config.mc_packed,
                        mesh_devices=self.config.mesh_devices,
                    )
                except InsufficientMemory as e:
                    # the mesh tier's conversion point (docs/SERVING.md
                    # "Mega-board sessions"): a never-fits verdict on a
                    # worker with a reserved slice is a PLACEMENT, not a
                    # rejection — re-mint the key as mesh:RxC (capacity
                    # 1, sharded over the slice) and re-run admission
                    # against the same reserved set
                    mesh_key = None
                    if (
                        not e.transient
                        and mesh_shape is None
                        and self.config.mesh_devices >= 2
                        and not rule.stochastic
                    ):
                        mesh_key, mesh_shape = self._plan_mesh_key(rule, board)
                    if mesh_key is None:
                        _record_reject(e)
                        raise
                    try:
                        self._governor.check_admission(
                            mesh_key,
                            reserved,
                            self._memory_budget,
                            1,
                            mc_packed=self.config.mc_packed,
                        )
                    except InsufficientMemory as e2:
                        mesh_shape = None
                        _record_reject(e2)
                        raise
                    obs.flight.record(
                        "mesh.placement",
                        trace_id=trace_id,
                        rule=rule.name,
                        mesh=f"{mesh_shape[0]}x{mesh_shape[1]}",
                        estimated_bytes=e.estimated_bytes,
                    )
            # backpressure check BEFORE the session exists anywhere; a bounce
            # is an admission outcome worth counting (rejection rate is the
            # first overload signal), so the counter ticks before the raise
            try:
                self.scheduler.ensure_admission()
            except QueueFull:
                self._c_rejections.inc()
                self._c_adm_rejected.labels(reason="queue_full").inc()
                obs.flight.record(
                    "rejection", reason="queue_full", trace_id=trace_id
                )
                raise
            now = self.clock()
            if timeout_s is None:
                timeout_s = self.config.default_timeout_s
            s = self.store.create(
                board=board.copy(),
                rule=rule,
                steps=steps,
                submitted_at=now,
                deadline=None if timeout_s is None else now + timeout_s,
                fault_at=fault_at,
                seed=seed,
                temperature=None if temperature is None else float(temperature),
                start_step=start_step,
                trace_id=trace_id,
                edits=edit_history,
                scheduled_edits=edit_scheduled,
                stream_seq=stream_seq,
                tenant=tenant,
            )
            if mesh_shape is not None:
                # the mega-board stamp: the keyer mints mesh:RxC from it,
                # the view renders it, the spill pass goes shard-wise
                s.mesh = mesh_shape
            if mesh_resume_rec is not None:
                # ownership transfer by rename (atomic on one filesystem):
                # the survivor's store adopts the tile set under the NEW
                # sid, so the session is durable from round one and the
                # victim-directory cleanup finds nothing left to delete.
                # A failed rename (cross-device) falls back to reading
                # the tiles in place.
                import dataclasses as _dc

                rec = mesh_resume_rec
                adopt = getattr(self._spill, "adopt_mesh", None)
                if adopt is not None:
                    new_root = adopt(s.sid, rec.root)
                    if new_root is not None:
                        rec = _dc.replace(rec, root=new_root)
                s.mesh_resume = rec.block_loader()
            # the admission flight event (docs/OBSERVABILITY.md): one
            # ring append per accepted session — what the doctor joins
            # the journey's start on.  start_step > 0 marks a resumed
            # (migrated) life of an existing trajectory.
            obs.flight.record(
                "admission",
                sid=s.sid,
                trace_id=trace_id,
                rule=s.rule.name,
                steps=steps,
                start_step=start_step,
            )
            if start_step > 0 and self._spill is not None:
                # spill-on-adopt (docs/FLEET.md): this submission carries a
                # RESCUED trajectory — until it is spilled HERE, a second
                # kill loses it (a known limit).  Mark it urgent so
                # the very next spill-capable round writes it, cadence or
                # not, and back-to-back kills degrade to one extra rescue
                # instead of a 410 never_snapshotted.
                s.spill_urgent = True
                self._spill_urgent_pending += 1
            self._c_submitted.inc()
            if steps == 0:
                # nothing to run: complete at admission, never costs a slot
                s.finish(board.copy())
                self._c_finished.labels(state=s.state.value).inc()
                self._h_latency.observe(0.0)
                self._completed += 1
                # the journey still needs its terminal event: this branch
                # bypasses the scheduler (no session_finished hook), and
                # a doctor reading only the admission would flag a
                # cleanly-done session as no_terminal
                obs.flight.record(
                    "terminal",
                    sid=s.sid,
                    trace_id=trace_id,
                    outcome=s.state.value,
                    step=start_step,
                )
            else:
                self.scheduler.enqueue(s)
                # the per-session queue-wait interval: an async (overlapping)
                # trace span, closed at admission or terminal-in-queue —
                # carrying the trace context so the merged fleet timeline
                # shows WHOSE wait this was
                with obs.activate(self._tracer):
                    obs.async_begin(
                        "queue-wait", s.sid, steps=steps, trace_id=trace_id
                    )
        log.debug("serve: submitted %s (%s, %d steps)", s.sid, rule.name, steps)
        return s.sid

    def _quota_reject(self, tenant: str, reason: str, trace_id) -> None:
        """Account one typed tenant-quota rejection (docs/SERVING.md
        "Tenant QoS"): the admission-rejection reason row, the
        per-tenant shed counter, and the flight event the doctor joins."""
        self._c_adm_rejected.labels(reason=reason).inc()
        self._c_tenant_shed.labels(
            tenant=tenant_label(tenant), reason=reason
        ).inc()
        obs.flight.record(
            "rejection", reason=reason, tenant=tenant, trace_id=trace_id
        )

    def sweep(
        self,
        board: np.ndarray,
        rule: Rule | str,
        steps: int,
        temperatures,
        *,
        seed: int = 0,
        timeout_s: float | None = None,
    ) -> list[str]:
        """Fan a temperature grid into one session per temperature (the
        JAX package's ``sweep``).

        The continuous-batching shape of a Monte-Carlo parameter sweep:
        every session shares the same board, seed and rule, so they all
        land in ONE CompileKey and one build of the batched chunk — the
        per-slot acceptance tables are the only thing that differs.
        Returns the session ids in temperature order.  Admission semantics
        are exactly N ``submit`` calls: a full queue raises
        :class:`QueueFull` on the session that did not fit (earlier ones
        stay admitted — pump and resubmit).
        """
        temps = [float(t) for t in temperatures]
        if not temps:
            raise ValueError("sweep needs at least one temperature")
        return [
            self.submit(board, rule, steps, timeout_s=timeout_s, seed=seed, temperature=t)
            for t in temps
        ]

    def poll(self, sid: str) -> SessionView:
        with self._lock:
            return self.store.view(sid)

    def result(self, sid: str) -> np.ndarray:
        with self._lock:
            return self.store.result(sid)

    def cancel(self, sid: str) -> bool:
        """Stop a session wherever it is; True if this call stopped it.

        Cancelling a RUNNING session frees its batch slot at the next
        round boundary semantics: the slot is released immediately, the
        engine's freeze mask stops stepping it, and the partial board is
        discarded (``steps_done`` records how far it got).
        """
        with self._lock:
            s = self.store.get(sid)
            if s.state in TERMINAL:
                return False
            if s.state is SessionState.QUEUED:
                self.scheduler.remove_queued(s)
            else:
                self.scheduler.evict_running(s)
            s.cancel()
            with obs.activate(self._tracer):
                self.session_finished(s, max(0.0, self.clock() - s.submitted_at))
            return True

    # -- mid-run steering + the streaming result channel --------------------
    def edit_cells(self, sid: str, cells) -> SessionView:
        """Apply a validated cell-mask to a live session between chunks
        (docs/STREAMING.md "Edits"): the PATCH verb behind
        ``/v1/sessions/{sid}/cells``.

        A QUEUED session's board is mutated in place (logged at
        ``start_step`` — the edit is part of the board the run starts
        from); a RUNNING session's edit is queued on the session and
        drained by the scheduler at the next round boundary through the
        freeze-mask seam (collect -> peek -> mutate -> reload), logged at
        the materialized step it lands on.  Every applied edit enters the
        session's edit log, which spills with the manifest — so the
        bit-reproducibility contract extends to steered sessions.  Typed
        ``ValueError`` on a terminal session, a session whose compute
        already finished, or a malformed mask.
        """
        with self._lock:
            s = self.store.get(sid)
            if s.state in TERMINAL:
                raise ValueError(
                    f"session {sid} is {s.state.value}; cannot edit a "
                    f"terminal session"
                )
            if s.state is SessionState.RUNNING and s.steps_remaining == 0:
                raise ValueError(
                    f"session {sid} has finished computing (awaiting "
                    f"retirement); cannot edit"
                )
            validated = validate_cells(cells, s.board.shape, s.rule)
            if s.state is SessionState.QUEUED:
                for r, c, v in validated:
                    s.board[r, c] = v
                s.edits.append((s.start_step, validated))
                with obs.activate(self._tracer):
                    self.session_edited(s, s.start_step, validated)
            else:
                s.pending_edits.append(validated)
            return self.store.view(sid)

    def stream_subscribe(self, sid: str, cursor: int = 0) -> None:
        """Register one watcher of ``sid``'s delta stream.

        The FIRST watcher of a session charges the stream's estimated
        ring bytes against the memory budget (docs/SERVING.md "Resource
        governance") — transient :class:`InsufficientMemory` when it
        does not fit next to the reserved engines, so a watcher storm
        backpressures typed instead of growing the worker until the OOM
        killer finds it.  Subscribing to an already-terminal session
        still yields a stream: one final keyframe plus the ``end`` frame.
        """
        with self._lock:
            s = self.store.get(sid)  # UnknownSession -> 404 upstream
            if sid not in self._stream_charged:
                # tenant watcher-buffer quota (docs/SERVING.md "Tenant
                # QoS"): a NEW session ring counts against its tenant's
                # max_watchers before any bytes are charged
                if self._qos is not None and s.tenant is not None:
                    spec = self._qos.spec(s.tenant)
                    if spec.max_watchers is not None:
                        mine = 0
                        for other in self._stream_charged:
                            o = self.store._sessions.get(other)
                            if o is not None and o.tenant == s.tenant:
                                mine += 1
                        if mine >= spec.max_watchers:
                            self._quota_reject(
                                s.tenant, "quota_watchers", s.trace_id
                            )
                            raise QuotaExceeded(
                                f"tenant {s.tenant!r} already holds "
                                f"{mine} watcher buffers; its "
                                f"max_watchers quota is "
                                f"{spec.max_watchers}",
                                tenant=s.tenant,
                                quota="max_watchers",
                                limit=spec.max_watchers,
                            )
                est = estimate_stream_bytes(
                    s.board.shape, str(s.board.dtype), self.hub.ring_frames
                )
                if self._memory_budget is not None:
                    reserved = sum(
                        self._governor.reserved_bytes(
                            self.scheduler.engines,
                            (self._keyer()(q) for q in self.scheduler.queue),
                            self.config.capacity,
                            mc_packed=self.config.mc_packed,
                        ).values()
                    )
                    charged = sum(self._stream_charged.values())
                    if reserved + charged + est > self._memory_budget:
                        self._c_rejections.inc()
                        self._c_adm_rejected.labels(
                            reason="watcher_buffer"
                        ).inc()
                        obs.flight.record(
                            "rejection",
                            reason="watcher_buffer",
                            sid=sid,
                            trace_id=s.trace_id,
                        )
                        raise InsufficientMemory(
                            f"watcher buffer for {sid} needs ~{est} bytes "
                            f"next to {reserved + charged} reserved; budget "
                            f"is {self._memory_budget}",
                            transient=True,
                            estimated_bytes=est,
                            budget_bytes=self._memory_budget,
                        )
                self._stream_charged[sid] = est
            self.hub.subscribe(sid, start_seq=s.stream_seq)
            if s.state in TERMINAL:
                step = s.start_step + s.steps_done
                if s.state is SessionState.DONE and s.result is not None:
                    self.hub.produce(
                        sid, s.result, step, executor=self.config.backend
                    )
                self.hub.finish(sid, s.state.value, step)

    def stream_read(
        self, sid: str, cursor: int, timeout: float | None = 0.25
    ) -> tuple[list, int, bool]:
        """Blocking frame read — NO service lock held (the hub has its
        own condition), so a watcher waiting on frames never delays
        submit/poll/cancel or the pump.  Returns
        ``(frames, next_cursor, eof)``."""
        return self.hub.read(sid, cursor, timeout)

    def stream_unsubscribe(self, sid: str) -> None:
        with self._lock:
            if self.hub.unsubscribe(sid):
                # last watcher gone: the ring state was discarded, so the
                # governor charge is released with it
                self._stream_charged.pop(sid, None)

    def _produce_frames(self) -> None:
        """The pump's frame tap (locked, both pump shapes): one hub
        append per watched session per round, read from each engine's
        double buffer (``peek_slot`` — the materialized board at
        ``start_step + steps_done - lag``; never waits on the in-flight
        chunk).  Queued watched sessions get their initial keyframe from
        the submitted board, so a watcher sees the start state while the
        session still waits for a slot."""
        if not self.hub.active():
            return
        sched = self.scheduler
        for key, slots in sched.running.items():
            engine = sched.engines.get(key)
            if engine is None:
                continue
            label = f"{key.backend}:{type(engine).__name__}"
            for slot, s in list(slots.items()):
                if not self.hub.wants(s.sid):
                    continue
                try:
                    board, lag = engine.peek_slot(slot)
                except recovery.RECOVERABLE:
                    continue  # the recovery path owns this engine now
                self.hub.produce(
                    s.sid,
                    np.asarray(board),
                    s.start_step + s.steps_done - lag,
                    executor=label,
                )
        for s in sched.queue:
            if self.hub.wants(s.sid):
                self.hub.produce(
                    s.sid, s.board, s.start_step, executor="queued"
                )

    # -- scheduler telemetry observer ---------------------------------------
    def session_admitted(self, session, wait_s: float) -> None:
        """Scheduler hook: a session got its batch slot after ``wait_s``."""
        self._h_queue_wait.observe(wait_s)
        obs.async_end("queue-wait", session.sid)
        # the per-session execution interval (docs/OBSERVABILITY.md
        # "Distributed tracing"): an async b/e pair from slot admission
        # to the terminal transition, keyed by sid and stamped with the
        # trace context — the interval the doctor's no-double-execution
        # invariant compares across worker incarnations.  A salvage-
        # reloaded session (engine recovery) re-begins under the same id;
        # Perfetto nests re-begins and the doctor keys on the outer pair.
        obs.async_begin(
            "serve.exec",
            session.sid,
            trace_id=session.trace_id,
            step=session.start_step + session.steps_done,
        )

    def session_edited(self, session, step: int, cells) -> None:
        """Scheduler hook: an edit-log entry was applied to ``session``
        at absolute ``step`` (also called directly for QUEUED edits).
        The stream mirrors it as a metadata frame; the flight ring keeps
        the steering decision for postmortems."""
        self.hub.record_edit(session.sid, step, cells)
        obs.flight.record(
            "edit",
            sid=session.sid,
            trace_id=session.trace_id,
            step=step,
            cells=len(cells),
        )
        obs.instant(
            "serve.session.edit",
            sid=session.sid,
            trace_id=session.trace_id,
            step=step,
            cells=len(cells),
        )

    def session_finished(self, session, latency_s: float) -> None:
        """Scheduler hook: a session reached a terminal state (done /
        failed / cancelled) ``latency_s`` after submission."""
        self._c_finished.labels(state=session.state.value).inc()
        self._h_latency.observe(latency_s)
        if self.hub.wants(session.sid):
            # close the stream: a DONE session's watchers get the final
            # board (keyframe) then the terminal frame; failed/cancelled
            # get the terminal frame alone — every read drains to EOF
            step = session.start_step + session.steps_done
            if (
                session.state is SessionState.DONE
                and session.result is not None
            ):
                self.hub.produce(
                    session.sid,
                    session.result,
                    step,
                    executor=self.config.backend,
                )
            self.hub.finish(session.sid, session.state.value, step)
        if self._spill is not None:
            # a terminal session must never resume: its spill dies with it
            self._spill.delete(session.sid)
        if session.admitted_at is None:
            # it died waiting: close the still-open queue-wait interval
            obs.async_end("queue-wait", session.sid, outcome=session.state.value)
        else:
            obs.async_end(
                "serve.exec",
                session.sid,
                trace_id=session.trace_id,
                outcome=session.state.value,
                step=session.start_step + session.steps_done,
            )
        obs.flight.record(
            "terminal",
            sid=session.sid,
            trace_id=session.trace_id,
            outcome=session.state.value,
            step=session.start_step + session.steps_done,
        )

    def engine_recovered(self, key, outcome: str) -> None:
        """Scheduler hook: a chunk-level fault on ``key`` was handled —
        masked in place (``replayed`` / the OOM ladder rungs) or, past
        the restart budget, failed typed (``budget_exhausted``)."""
        self._c_recoveries.labels(outcome=outcome).inc()
        bucket = _key_bucket(key)
        obs.instant("serve.recovery", compile_key=bucket, outcome=outcome)
        obs.flight.record("recovery", compile_key=bucket, outcome=outcome)

    def drain(self, max_rounds: int | None = None) -> int:
        """Pump until every admitted session reaches a terminal state;
        returns the number of rounds run.  ``max_rounds`` bounds a stuck
        drain (it raises rather than spinning forever)."""
        rounds = 0
        with obs.activate(self._tracer), maybe_profile(self.config.profile):
            while not self.idle():
                self.pump()
                rounds += 1
                if max_rounds is not None and rounds >= max_rounds:
                    if not self.idle():
                        raise RuntimeError(
                            f"drain did not converge in {max_rounds} rounds "
                            f"({len(self.scheduler.queue)} queued)"
                        )
                    break
        return rounds

    def begin_drain(self) -> None:
        """Close admission (every later ``submit`` raises :class:`Draining`)
        while in-flight sessions keep running — the graceful-shutdown hook.
        The caller still pumps (or ``drain()``s) to completion and then
        ``close()``s; this only flips the admission valve."""
        with self._lock:
            if not self._draining:
                self._draining = True
                log.info("serve: draining — admission closed")

    @property
    def draining(self) -> bool:
        return self._draining

    def rebind_spill(self, namespace: str) -> None:
        """Re-point a REMOTE spill backend at a fresh incarnation
        namespace (docs/FLEET.md "Cross-host topology"): a wire-registered
        worker calls this when the control plane grants it a new
        ``(worker, generation)`` — its spills must land in the namespace
        the migrator will read for THAT incarnation.  Typed error on a
        local (or absent) backend: only the HTTP store has namespaces."""
        if self._spill is None or not hasattr(self._spill, "set_namespace"):
            raise ValueError(
                "rebind_spill needs a remote spill backend (spill_url)"
            )
        self._spill.set_namespace(namespace)

    def cancel_live(self, reason: str = "cancelled") -> int:
        """Cancel every non-terminal session; returns how many.  The
        fenced-worker recourse (docs/FLEET.md): a worker refused with
        ``lease_expired`` learned its sessions were RESCUED elsewhere —
        finishing its local copies would double-execute trajectories the
        fleet already re-homed, so it drops them before re-registering."""
        with self._lock:
            sids = [s.sid for s in self.store.live()]
        n = sum(1 for sid in sids if self.cancel(sid))
        if n:
            log.warning("serve: cancelled %d live session(s): %s", n, reason)
        return n

    def idle(self) -> bool:
        """True when nothing is queued or resident in any batch slot."""
        with self._lock:
            return self.scheduler.idle()

    # -- the scheduling quantum -------------------------------------------
    def pump(self) -> RoundStats:
        """One scheduling round; the only place device work happens.

        The pipelined pump (default) holds the service lock only for its
        begin/end phases — the settle window, where device chunks and
        host-engine compute actually finish, runs unlocked so ``submit``
        and ``poll`` are never blocked behind device work.  The sync pump
        holds the lock for the whole round (the classic seam: handlers
        never touch engines, the pump never sees a half-enqueued session).
        """
        if not self.config.pipeline:
            with self._lock:
                return self._pump_locked()
        with self._pump_mutex:
            return self._pump_pipelined()

    def _keyer(self):
        cfg = self.config
        from tpu_life_torch.ops.conv import resolve_stencil

        def keyer(s) -> CompileKey:
            if getattr(s, "mesh", None) is not None:
                return self._mesh_key(s.rule, s.board, s.mesh)
            return compile_key_for(
                s.rule,
                s.board,
                cfg.backend,
                resolve_stencil(s.rule, cfg.stencil, cfg.backend),
            )

        return keyer

    # -- the mega-board mesh tier (docs/SERVING.md "Mega-board sessions") --
    def _mesh_key(self, rule, board, mesh_shape) -> CompileKey:
        """The ``mesh:RxC`` CompileKey for a placed mega-board.  The
        stencil resolves against the device-backend crossover model (the
        sharded blocks run the same stencil the device batch does), so a
        mega-board Lenia takes the banded-matmul path."""
        from tpu_life_torch.ops.conv import resolve_stencil
        from tpu_life_torch.serve.mesh_engine import mesh_backend_name

        return compile_key_for(
            rule,
            board,
            mesh_backend_name(mesh_shape),
            resolve_stencil(rule, self.config.stencil, "torch"),
        )

    def _plan_mesh_key(self, rule, board):
        """``(mesh_key, mesh_shape)`` for a never-fits board on this
        worker's reserved slice, or ``(None, None)`` when no legal mesh
        factorization exists (the rejection then stands, carrying the
        mesh_eligible hint for a bigger fleet)."""
        from tpu_life_torch.serve.mesh_engine import plan_mesh_shape

        shape = plan_mesh_shape(self.config.mesh_devices, board.shape, rule)
        if shape is None:
            return None, None
        return self._mesh_key(rule, board, shape), shape

    def _open_mesh_resume(self, mesh_resume_dir, rule, board_shape, steps, start_step):
        """Validate a shard-wise resume pointer against its tile-set
        manifest and this request; returns ``(record, mesh_shape)``.
        Raises ValueError (a typed 400 at the gateway) on any mismatch —
        before anything is stored."""
        from tpu_life_torch.serve.mesh_engine import plan_mesh_shape
        from tpu_life_torch.serve.spill import read_mesh_session_dir

        if self.config.mesh_devices < 2:
            raise ValueError(
                "mesh_resume_dir needs a worker with a reserved mesh "
                "slice (mesh_devices >= 2); this worker has "
                f"{self.config.mesh_devices}"
            )
        if rule.stochastic:
            raise ValueError(
                f"rule {rule.name!r} is stochastic: the mesh tier has no "
                "sharded Monte-Carlo path"
            )
        if steps < 1:
            raise ValueError("mesh_resume_dir with steps == 0 has nothing to run")
        rec = read_mesh_session_dir(mesh_resume_dir)
        if get_rule(rec.rule).name != rule.name:
            raise ValueError(
                f"tile set at {mesh_resume_dir} was spilled under rule "
                f"{rec.rule!r}, not {rule.name!r}"
            )
        if (rec.height, rec.width) != tuple(board_shape):
            raise ValueError(
                f"tile set at {mesh_resume_dir} is "
                f"{rec.height}x{rec.width}, not "
                f"{board_shape[0]}x{board_shape[1]}"
            )
        if int(start_step) != rec.step:
            raise ValueError(
                f"tile set's resumable epoch is step {rec.step}; "
                f"start_step {start_step} does not match"
            )
        shape = plan_mesh_shape(self.config.mesh_devices, board_shape, rule)
        if shape is None:
            raise ValueError(
                f"no legal {self.config.mesh_devices}-device mesh "
                f"factorization for a {board_shape[0]}x{board_shape[1]} "
                f"{rule.name} board"
            )
        return rec, shape

    def _pump_locked(self) -> RoundStats:
        with obs.activate(self._tracer), obs.span(
            "serve.round", round=self._rounds, pump="sync"
        ):
            stats = self.scheduler.round(self._keyer())
            self._produce_frames()
            plan = self._spill_plan()
            if plan:
                # the sync pump is fully settled after round(): every lag
                # is zero and every board materialized.  Spilling here
                # holds the lock (the sync pump holds it anyway).
                failures = self._run_spill(plan)
                self._apply_spill_failures(failures)
                self._sweep_spills(plan)
        self._finish_round(stats)
        return stats

    def _pump_pipelined(self) -> RoundStats:
        keyer = self._keyer()
        stats = RoundStats()
        with self._lock:
            with obs.activate(self._tracer), obs.span(
                "serve.round", round=self._rounds, pump="pipelined"
            ):
                plan = self.scheduler.round_begin(keyer, stats)
                rolled = {key for key, _, r in plan if r}
                for _, engine, _ in plan:
                    engine.busy = True
                # the spill plan is captured under the lock (the running
                # map is verb-mutable) but WRITTEN after settle, outside
                # it — durability must not block submit/poll/cancel
                spill_plan = self._spill_plan()
        # -- the overlap window: no service lock held.  Device chunks (and
        # host-engine compute) complete here while submit/poll/cancel stay
        # serviceable; verb-triggered slot releases defer to the next begin.
        spill_failures: list = []
        chunk_faults: list = []
        settled: list = []
        faulted: list = []
        # publish the settle window for the wedge watchdog: it reads
        # (start, plan, settled-so-far, faulted-so-far) from outside the
        # pump and fires once an engine blocks past settle_deadline_s
        # WITHOUT progress (each settled engine restarts the clock —
        # many keys legitimately settling in sequence is not a wedge)
        self._settle_state = (time.monotonic(), plan, settled, faulted)
        try:
            with obs.activate(self._tracer), obs.span(
                "serve.collect", engines=len(plan)
            ):
                for key, engine, was_rolled in plan:
                    try:
                        if was_rolled:
                            engine.settle()
                        else:
                            engine.collect_chunk()
                    except recovery.RECOVERABLE as e:
                        # a chunk-level fault while settling (the chaos
                        # engine.collect drill, or a real device reset):
                        # recorded here, RECOVERED under the lock below —
                        # rebuild + replay, this pump round survives.
                        # NOT marked settled: the wedge salvage must
                        # never fetch from an engine whose chunk just
                        # died (recover_engine owns its sessions).
                        chunk_faults.append((key, e))
                        faulted.append(key)
                    else:
                        settled.append(key)
            # the watchdog window closes HERE: every device wait is done.
            # The spill pass below is disk I/O — slow storage must never
            # read as a wedged device grant
            self._settle_state = None
            if spill_plan:
                # engines are settled (double buffers materialized) and
                # still marked busy, so verb releases stay deferred and
                # every peek reads stable state; a session cancelled
                # during the write is swept under the lock below.  The
                # tracer is re-activated: this runs outside the round's
                # activate block, and the spill span belongs to THIS
                # service's timeline, not whatever is ambient.
                with obs.activate(self._tracer):
                    spill_failures = self._run_spill(spill_plan)
        finally:
            self._settle_state = None
            with self._lock:
                for _, engine, _ in plan:
                    engine.busy = False
        with self._lock:
            with obs.activate(self._tracer):
                for key, exc in chunk_faults:
                    self.scheduler.recover_engine(key, exc, stats)
                self.scheduler.round_end(keyer, stats, rolled)
                self._produce_frames()
            if spill_plan:
                self._apply_spill_failures(spill_failures)
                self._sweep_spills(spill_plan)
            self._finish_round(stats)
        return stats

    # -- the wedge watchdog (docs/SERVING.md "Resource governance") ---------
    @property
    def wedged(self) -> dict | None:
        """The wedge verdict: None while healthy, else a machine-readable
        dict (``reason`` / ``compile_key`` / ``deadline_s`` /
        ``waited_s``) — what ``/readyz`` serializes into its 500 body.
        Sticky by design: a declared wedge means the settle-deadline
        contract was broken, and the supervisor recycle path owns the
        recovery from here."""
        return self._wedged

    def _watchdog_loop(self) -> None:
        deadline = float(self.config.settle_deadline_s)
        poll = max(0.01, min(0.25, deadline / 4))
        # progress tracking: the deadline applies to ONE engine's wait,
        # not the cumulative multi-engine window — every engine that
        # settles (or faults into the recovery path) restarts the clock,
        # so N keys legitimately settling in sequence never trip it
        last_state: tuple | None = None
        last_progress = -1
        baseline = 0.0
        while not self._watchdog_stop.wait(poll):
            state = self._settle_state
            if state is None or self._wedged is not None:
                last_state = None
                continue
            started, plan, settled, faulted = state
            progress = len(settled) + len(faulted)
            now = time.monotonic()
            if state is not last_state:
                last_state, last_progress, baseline = state, progress, started
            elif progress != last_progress:
                last_progress, baseline = progress, now
            if now - baseline <= deadline:
                continue
            waited = now - baseline
            # the stuck pump does NOT hold the service lock during the
            # settle window — that is the whole design of the pipelined
            # pump — so the watchdog can take it and act
            with self._lock:
                if self._settle_state is not state or self._wedged is not None:
                    continue  # the window closed while we queued
                skip = set(settled) | set(faulted)
                # the engine actually blocked: the first plan entry that
                # neither settled nor faulted (a faulted key already
                # failed over to recover_engine — blaming it would put
                # the wrong compile_key in the operator-facing verdict)
                stuck = next((k for k, _, _ in plan if k not in skip), None)
                if stuck is None:
                    # every engine settled or faulted: the window is
                    # logically over even if the pump has not cleared the
                    # state yet — nothing is wedged on a device
                    continue
                self._wedged = {
                    "reason": "settle_deadline",
                    "compile_key": (
                        _key_bucket(stuck) if stuck is not None else None
                    ),
                    "deadline_s": deadline,
                    "waited_s": waited,
                }
                self._c_recoveries.labels(outcome="wedged").inc()
                obs.flight.record("wedge", **self._wedged)
                # salvage only from SETTLED engines — a faulted engine's
                # chunk died and recover_engine owns its sessions.  NO
                # obs.activate here: the tracer's active slot is one
                # process global, and the wedged pump is still inside
                # its own activate scope on another thread — nesting a
                # second scope from the watchdog races the restore and
                # can leak (or drop) the active tracer.  The salvaged
                # sessions' terminal evidence rides the flight ring
                # instead (session_finished records it unconditionally;
                # the ring is lock-protected and activate-independent),
                # which is what the doctor reads outcomes from.
                salvaged = self._salvage_wedged_locked(plan, set(settled))
            log.error(
                "serve: WEDGED — settle window blocked %.1fs (deadline "
                "%.1fs) on %s; %d finisher(s) salvaged, /readyz now "
                "answers 500 engine_wedged so the supervisor's "
                "unready-recycle + migration path rescues the sessions",
                waited,
                deadline,
                self._wedged["compile_key"],
                salvaged,
            )

    def _salvage_wedged_locked(self, plan, settled: set) -> int:
        """Retire the pending finishers of engines that SETTLED before
        the wedge: their double buffers are materialized and the stuck
        pump is blocked in a different engine, so fetching them here
        (under the service lock) is safe — those results leave the
        worker before the supervisor recycles it."""
        sched = self.scheduler
        stats = RoundStats()
        for key, engine, _ in plan:
            if key not in settled:
                continue
            entries = sched.pending.get(key) or []
            slots = sched.running.get(key, {})
            for slot, s in list(entries):
                if slots.get(slot) is not s:
                    continue  # cancelled/expired meanwhile
                sched._retire_slot(engine, slots, slot, s, stats)
            sched.pending.pop(key, None)
        self._completed += stats.completed
        return stats.completed

    # -- durable sessions: the spill pass (docs/SERVING.md) -----------------
    def _spill_plan(self) -> list | None:
        """Locked: decide whether this round spills and capture what —
        ``(session, engine, slot)`` for every resident slot (engine=None
        for queued sessions, whose board is still the submitted copy)."""
        if self._spill is None:
            return None
        self._rounds_since_spill += 1
        due = self._rounds_since_spill >= self.config.spill_every
        if due:
            self._rounds_since_spill = 0
        elif self._spill_urgent_pending == 0:
            return None  # off-cadence, nothing urgent: the cheap path
        plan = []
        # an URGENT session (a just-adopted rescue, spill-on-adopt) rides
        # every round until its first successful write, cadence or not —
        # between resume-accept and that write, a second kill would lose
        # a trajectory a client was already promised survives kills
        urgent = 0
        for key, slots in self.scheduler.running.items():
            engine = self.scheduler.engines[key]
            for slot, s in slots.items():
                if not s.spill_disabled and (due or s.spill_urgent):
                    plan.append((s, engine, slot))
                    urgent += s.spill_urgent
        for s in self.scheduler.queue:
            if not s.spill_disabled and (due or s.spill_urgent):
                plan.append((s, None, None))
                urgent += s.spill_urgent
        # the walk recomputes the truth: spent/terminal urgencies drop out
        self._spill_urgent_pending = urgent
        return plan or None

    def _run_spill(self, plan: list) -> list:
        """Pump thread, engines settled: write each planned session's
        newest materialized board + manifest through the checkpoint
        contract.  Sessions that went terminal since the plan was taken
        are skipped (and swept under the lock afterwards).  Returns the
        ``(session, error)`` write failures — an ENOSPC (or any OSError)
        must NOT escape into the pump (it would kill the whole worker
        over one session's durability); the locked round tail degrades
        those sessions to spill-disabled instead."""
        t0 = time.monotonic()
        now = self.clock()
        failures: list = []
        with obs.span("serve.spill", sessions=len(plan)):
            for s, engine, slot in plan:
                if s.state in TERMINAL or s.spill_disabled:
                    continue
                if getattr(s, "mesh", None) is not None:
                    # mega-board sessions spill shard-wise (docs/SERVING.md
                    # "Mega-board sessions") — never through the
                    # full-board path, which would gather the one thing
                    # the tier exists to never materialize
                    err = self._spill_mesh(s, engine, slot, now)
                    if err is not None:
                        failures.append((s, err))
                    continue
                if engine is None:
                    board, lag = s.board, 0
                else:
                    board, lag = engine.peek_slot(slot)
                abs_step = s.start_step + s.steps_done - lag
                timeout_s = (
                    None if s.deadline is None else max(0.0, s.deadline - now)
                )
                # the steered-session manifest fields (docs/STREAMING.md):
                # the applied edit log (bit-reproducibility provenance),
                # the not-yet-applied tail a survivor must re-apply at
                # exactly the recorded steps, and the stream-sequence
                # floor a reconnected watcher stays gapless under.  Both
                # lists are pump-thread-private (apply_edits mutates them
                # in the locked begin phase, this pass runs on the same
                # thread), so reading them unlocked is safe.
                edits = render_edit_log(s.edits) or None
                scheduled = render_edit_log(s.scheduled_edits) or None
                try:
                    self._spill.save(
                        s.sid,
                        board,
                        abs_step,
                        rule=s.rule.name,
                        steps_total=s.start_step + s.steps,
                        seed=s.seed,
                        temperature=s.temperature,
                        timeout_s=timeout_s,
                        trace_id=s.trace_id,
                        edits=edits,
                        scheduled_edits=scheduled,
                        stream_seq=self.hub.seq_snapshot(
                            s.sid, default=s.stream_seq
                        ),
                    )
                    # the per-session durability marker: WHICH recovery
                    # point this trace now has (instant() is a no-op
                    # without an active tracer — one global check)
                    obs.instant(
                        "serve.session.spill",
                        sid=s.sid,
                        trace_id=s.trace_id,
                        step=abs_step,
                    )
                    # the adopted trajectory is durable again: the
                    # spill-on-adopt urgency is spent (a plain bool flip —
                    # benign against the locked plan capture; the worst
                    # race costs one redundant spill next round)
                    s.spill_urgent = False
                except OSError as e:
                    # the disk work of the degradation (drop the stale
                    # snapshots, publish the DISABLED marker) happens
                    # HERE, in the pump's unlocked window — a full or
                    # HUNG disk must never stall the service lock; the
                    # locked tail only flips the flag and the counter.
                    # A session that goes terminal meanwhile is swept
                    # (marker and all) by _sweep_spills, like any spill.
                    self._spill.mark_disabled(s.sid)
                    failures.append((s, e))
        dt = time.monotonic() - t0
        self._h_snapshot.observe(dt)
        self._snapshot_s_total += dt
        return failures

    def _spill_mesh(self, s, engine, slot, now) -> Exception | None:
        """Shard-wise spill of one mega-board session (pump thread,
        unlocked): walk the engine's addressable shards and persist one
        tile per shard through the store's tile contract — each host
        writes only its own bytes.  Returns the failure (for the locked
        degradation tail) instead of raising, like the board path.

        Skips silently while the session is still QUEUED (engine=None):
        a mesh board only becomes spillable once it is resident on its
        slice — the submitted copy is either the client's resubmittable
        request or, on a resume, a geometry placeholder that must never
        overwrite good tiles."""
        if engine is None or not hasattr(engine, "spill_tiles"):
            return None
        if not getattr(self._spill, "SUPPORTS_MESH", False):
            # the remote HTTP store has no tile contract (yet): shipping
            # a gathered mega-board over it would defeat the tier, so
            # durability degrades for this session alone — the same
            # contract as a failed write, and just as visible
            self._spill.mark_disabled(s.sid)
            return OSError(
                "spill backend has no shard-wise tile contract "
                "(mesh sessions need a local spill_dir)"
            )
        try:
            tiles, lag = engine.spill_tiles(slot)
            abs_step = s.start_step + s.steps_done - lag
            timeout_s = (
                None if s.deadline is None else max(0.0, s.deadline - now)
            )
            self._spill.save_mesh(
                s.sid,
                tiles,
                abs_step,
                rule=s.rule.name,
                steps_total=s.start_step + s.steps,
                seed=s.seed,
                temperature=s.temperature,
                timeout_s=timeout_s,
                height=int(s.board.shape[0]),
                width=int(s.board.shape[1]),
                mesh=s.mesh,
                trace_id=s.trace_id,
                edits=render_edit_log(s.edits) or None,
                scheduled_edits=render_edit_log(s.scheduled_edits) or None,
                stream_seq=self.hub.seq_snapshot(s.sid, default=s.stream_seq),
            )
            obs.instant(
                "serve.session.spill",
                sid=s.sid,
                trace_id=s.trace_id,
                step=abs_step,
                mesh=f"{s.mesh[0]}x{s.mesh[1]}",
                tiles=len(tiles),
            )
            s.spill_urgent = False
            return None
        except OSError as e:
            self._spill.mark_disabled(s.sid)
            return e

    def _apply_spill_failures(self, failures: list) -> None:
        """Locked: degrade each failed write's session to spill-disabled —
        one counter tick and ONE log line per session (it leaves the spill
        plan, so it can never re-fail or re-log).  The DISABLED marker
        was already published by the unlocked spill pass; the session
        itself keeps running: a full disk costs durability, never the
        service."""
        for s, e in failures:
            if s.spill_disabled:
                continue
            s.spill_disabled = True
            self._c_spill_errors.inc()
            obs.flight.record(
                "spill_disabled", sid=s.sid, trace_id=s.trace_id, error=str(e)
            )
            log.warning(
                "serve: spill write for %s failed (%s); durability disabled "
                "for this session — it keeps running without failover cover",
                s.sid,
                e,
            )

    def _sweep_spills(self, plan: list) -> None:
        """Locked: drop spills of sessions that reached a terminal state
        while (or after) the unlocked spill pass wrote them — closes the
        cancel-races-the-writer window, so no terminal session ever
        leaves a resumable spill behind."""
        for s, _, _ in plan:
            if s.state in TERMINAL:
                self._spill.delete(s.sid)

    def _finish_round(self, stats: RoundStats) -> None:
        """The locked round tail shared by both pump shapes: counters,
        gauges, the per-round metrics record, the live prom snapshot."""
        self._completed += stats.completed
        self._rounds += 1
        self._steps_total += stats.steps_advanced
        self._steps_packed_total += stats.steps_advanced_packed
        self._c_rounds.inc()
        if stats.steps_advanced:
            self._c_steps.inc(stats.steps_advanced)
        if stats.steps_advanced_packed:
            self._c_steps_packed.inc(stats.steps_advanced_packed)
        occ = stats.occupancy / stats.slots if stats.slots else 0.0
        self._occupancy_sum += occ
        self._g_queue_depth.set(stats.queue_depth)
        self._g_queue_age.set(self.scheduler.queue_age_oldest_s())
        self._g_occupancy.set(occ)
        depth = sum(1 for e in self.scheduler.engines.values() if e.inflight)
        self._g_pipeline_depth.set(depth)
        matmul_keys = sum(
            1
            for e in self.scheduler.engines.values()
            if getattr(e, "stencil", None) == "matmul"
        )
        self._g_matmul_keys.set(float(matmul_keys))
        idle_delta = self.scheduler.idle_seconds_delta()
        if idle_delta > 0:
            self._c_device_idle.inc(idle_delta)
        if self._spill is not None:
            self._g_spilled.set(float(self._spill.spilled_count()))
        if self._tracer is not None:
            # fold ring evictions into the loss counter (monotone: the
            # tracer's dropped count only grows; we tick the delta)
            dropped = self._tracer.dropped
            if dropped > self._trace_dropped_seen:
                self._c_trace_dropped.inc(dropped - self._trace_dropped_seen)
                self._trace_dropped_seen = dropped
        # mirror the stream hub's plain-int totals into the registry as
        # monotone deltas (same pattern as the trace-drop fold above)
        frames_now = self.hub.frames_total
        if frames_now > self._stream_frames_seen:
            self._c_stream_frames.inc(frames_now - self._stream_frames_seen)
            self._stream_frames_seen = frames_now
        gaps_now = self.hub.gaps_total
        if gaps_now > self._stream_gaps_seen:
            self._c_stream_gaps.inc(gaps_now - self._stream_gaps_seen)
            self._stream_gaps_seen = gaps_now
        stream_watchers = self.hub.watcher_count()
        self._g_stream_watchers.set(float(stream_watchers))
        for key, count in self.scheduler.compile_counts().items():
            self._g_compiles.labels(compile_key=_key_bucket(key)).set(count)
        # the governor's footprint view: what each live engine is charged
        # against the budget (same bounded key buckets as compile counts).
        # Unlike compile counts this is a LIVE footprint, so buckets of
        # released engines zero out instead of showing a stale charge.
        live_buckets = set()
        for key in self.scheduler.engines:
            bucket = _key_bucket(key)
            live_buckets.add(bucket)
            self._g_est_bytes.labels(key=bucket).set(
                float(
                    self._governor.estimate_engine_bytes(
                        key,
                        self.config.capacity,
                        mc_packed=self.config.mc_packed,
                    )
                )
            )
        for bucket in self._est_buckets - live_buckets:
            self._g_est_bytes.labels(key=bucket).set(0.0)
        self._est_buckets = live_buckets
        # the mesh tier's observability rows (docs/SERVING.md "Mega-board
        # sessions"): live mesh-sharded sessions, and the governor's
        # per-shard estimator rows for every live mesh engine — stale
        # (key, shard) rows zero out when the engine goes, like the
        # per-key footprint above
        mesh_sessions = sum(
            len(slots)
            for key, slots in self.scheduler.running.items()
            if str(getattr(key, "backend", "")).startswith("mesh:")
        )
        self._g_mesh_sessions.set(float(mesh_sessions))
        live_mesh = set()
        for key, e in self.scheduler.engines.items():
            shape = getattr(e, "mesh_shape", None)
            if shape is None:
                continue
            bucket = _key_bucket(key)
            for shard, per in self._governor.estimate_mesh_shard_bytes(
                key, shape
            ).items():
                live_mesh.add((bucket, shard))
                self._g_mesh_est_bytes.labels(key=bucket, shard=shard).set(
                    float(per)
                )
        for bucket, shard in self._mesh_est_buckets - live_mesh:
            self._g_mesh_est_bytes.labels(key=bucket, shard=shard).set(0.0)
        self._mesh_est_buckets = live_mesh
        # the per-tenant session rows (docs/SERVING.md "Tenant QoS"):
        # live counts per tenant label, stale buckets zeroed like the
        # governor footprint above.  Policy-less services skip the walk
        # entirely — zero label cardinality, zero cost.
        if self._qos is not None:
            live_tenants = set()
            for name, n in self.store.live_by_tenant().items():
                lbl = tenant_label(name)
                live_tenants.add(lbl)
                self._g_tenant_sessions.labels(tenant=lbl).set(float(n))
            for lbl in self._tenant_buckets - live_tenants:
                self._g_tenant_sessions.labels(tenant=lbl).set(0.0)
            self._tenant_buckets = live_tenants
        elapsed = self.clock() - self._t0
        qw, lat = self._h_queue_wait, self._h_latency
        self.recorder.record(
            {
                "kind": "serve",
                "pump": "pipelined" if self.config.pipeline else "sync",
                "elapsed_s": elapsed,
                "queue_depth": stats.queue_depth,
                "batch_occupancy": occ,
                "admitted": stats.admitted,
                "completed": stats.completed,
                "failed": stats.failed,
                "steps_advanced": stats.steps_advanced,
                # path attribution (docs/OBSERVABILITY.md): the slice of
                # this round's steps run by bitplane-packed engines, so
                # `tpu-life stats` splits throughput by storage path
                "steps_advanced_packed": stats.steps_advanced_packed,
                # the stencil stamp (docs/RULES.md): live engines on the
                # banded-matmul counting path, and each key's resolved
                # path — the per-round record a tailing consumer (and
                # the fleet merge) attributes throughput with
                "matmul_keys": matmul_keys,
                "stencil_keys": {
                    _key_bucket(k): e.stencil
                    for k, e in self.scheduler.engines.items()
                    if getattr(e, "stencil", None) is not None
                },
                # the mesh stamp (docs/SERVING.md "Mega-board sessions"),
                # present only on workers with a configured slice —
                # records of mesh-less workers keep their prior shape
                **(
                    {"mesh_sessions": mesh_sessions}
                    if self.config.mesh_devices
                    else {}
                ),
                "sessions_done": self._completed,
                "sessions_per_sec": self._completed / elapsed
                if elapsed > 0
                else 0.0,
                # the overlap stamps: in-flight chunks after this round's
                # dispatches, and cumulative engine-idle wall seconds
                "pipeline_depth": depth,
                "device_idle_s": self._c_device_idle.value,
                # the governor stamps (docs/SERVING.md "Resource
                # governance"): in-place recoveries this round, and the
                # cumulative ladder counter
                "engine_recoveries": stats.engine_recoveries,
                # the durability stamps (present only with a spill dir):
                # sessions currently resumable from disk, and cumulative
                # wall seconds spent writing spills
                **(
                    {
                        "spilled_sessions": self._spill.spilled_count(),
                        "snapshot_s": self._snapshot_s_total,
                        "spill_errors": self._c_spill_errors.value,
                    }
                    if self._spill is not None
                    else {}
                ),
                # the stream stamps (docs/STREAMING.md), present only
                # once the stream tier has ever been touched — records of
                # never-streamed services keep their pre-stream shape
                **(
                    {
                        "stream_watchers": stream_watchers,
                        "stream_frames_total": self._stream_frames_seen,
                        "stream_frame_gaps_total": self._stream_gaps_seen,
                    }
                    if stream_watchers or self._stream_frames_seen
                    else {}
                ),
                # live distribution snapshots (null until first sample):
                # the per-round record carries its histograms' quantiles so
                # a tailing consumer sees latency drift round by round
                "queue_wait_p50": qw.quantile(0.5),
                "queue_wait_p95": qw.quantile(0.95),
                "queue_wait_p99": qw.quantile(0.99),
                "completion_p50": lat.quantile(0.5),
                "completion_p95": lat.quantile(0.95),
            }
        )
        # the series sample rides the retire tail, rate-limited to one
        # snapshot per series_every_s no matter how fast rounds spin;
        # disabled sampling is the single is-None check above this line
        if self._series is not None:
            now_mono = self.clock()
            if now_mono >= self._series_next:
                self._series_next = now_mono + self.config.series_every_s
                self._series.sample(self.registry)
        if self.config.prom_file:
            # live exposition: rewrite the snapshot every round (atomic
            # rename, so a mid-run scrape never reads a torn file) instead
            # of only at close — a Prometheus file scraper watching a
            # long-lived serve sees queue depth move, not a stale zero
            self._write_prom()

    def _write_prom(self) -> None:
        path = self.config.prom_file
        obs.ensure_parent(path)
        with ckpt_atomic_publish(Path(path)) as tmp:
            tmp.write_text(self.registry.prom_text())

    def drain_trace(self) -> dict:
        """Take (and clear) the buffered trace + flight events — the
        payload behind the gateway's ``GET /v1/debug/trace`` drain verb
        (docs/OBSERVABILITY.md "Distributed tracing").  Each call is an
        increment: a fleet supervisor scraping on its monitor tick
        assembles the whole timeline without ever re-reading an event.
        With no tracer configured the span list is empty but the flight
        ring (always on) still drains — a no-trace worker still
        contributes its control-plane decisions to a postmortem."""
        t = self._tracer
        payload = {
            "run_id": self.run_id,
            "pid": os.getpid(),
            "now": time.time(),
            "wall_t0": t.wall_t0 if t is not None else None,
            "dropped": t.dropped if t is not None else 0,
            "events": t.drain() if t is not None else [],
            "flight": obs.flight.drain(),
        }
        return payload

    def read_series(self, cursor: int = 0) -> dict:
        """Retained metric snapshots with ``seq >= cursor`` — the payload
        behind ``GET /v1/debug/series?cursor=`` (docs/OBSERVABILITY.md
        "Time series").  Unlike the trace drain this read is
        NON-destructive and repeatable: the scraper owns the cursor, so
        a replayed scrape (or a second scraper) sees the same snapshots;
        ``dropped`` counts what the bounded ring evicted past the cursor
        before this read.  A disabled ring answers an empty, well-shaped
        payload rather than a 404 — the scraper needs no config probe."""
        if self._series is None:
            payload = {
                "schema": obs.timeseries.SERIES_SCHEMA,
                "snapshots": [],
                "next_cursor": 0,
                "dropped": 0,
            }
        else:
            payload = self._series.read(cursor)
        payload.update(run_id=self.run_id, pid=os.getpid(), now=time.time())
        return payload

    def flush(self) -> None:
        """Wait out any still-in-flight device chunks without running a
        new round.  The drain tail calls this after ``idle()`` turns true:
        a chunk whose sessions were all cancelled mid-flight is otherwise
        left executing with nobody to collect it."""
        with self._lock:
            self.scheduler.flush_inflight()

    def release_idle_engines(self) -> int:
        """Free engines (device batch + compiled program) whose keys have
        no resident sessions — for quiet periods of a long-lived service;
        returning traffic for a released key costs one recompile."""
        with self._lock:
            # harvest the idle tail first: deltas on a deleted engine are
            # gone, and the counter must stay monotonic across releases
            idle_delta = self.scheduler.idle_seconds_delta()
            if idle_delta > 0:
                self._c_device_idle.inc(idle_delta)
            return self.scheduler.release_idle_engines()

    def close(self) -> None:
        """Flush telemetry and release held resources: the registry
        snapshot lands in the JSONL sink, the Prometheus snapshot in
        ``prom_file``, the trace file is written, in-flight chunks
        collected, idle engines freed."""
        self._watchdog_stop.set()
        with self._lock:
            self.scheduler.flush_inflight()
            self.recorder.close()
            if self.config.prom_file:
                self._write_prom()
                log.info("prometheus snapshot -> %s", self.config.prom_file)
            if self._tracer is not None:
                # the flight-recorder dump (docs/OBSERVABILITY.md): what
                # is still in the control-plane ring rides into the
                # written file as instant markers, so a solo gateway's
                # trace file is a self-contained postmortem capture
                t = self._tracer
                for ev in obs.flight.snapshot():
                    t._emit(
                        obs.flight.as_instant(
                            ev,
                            pid=os.getpid(),
                            ts=max(0.0, (ev["t"] - t.wall_t0) * 1e6),
                        )
                    )
                obs.stop_tracing(self._tracer)
                log.info(
                    "trace events -> %s (run_id=%s)", self._tracer.path, self.run_id
                )
                self._tracer = None
            self.scheduler.release_idle_engines()

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        elapsed = self.clock() - self._t0
        return {
            "run_id": self.run_id,
            "draining": self._draining,
            "wedged": self._wedged,
            "memory_budget_bytes": self._memory_budget or 0,
            "engine_recoveries": {
                labels["outcome"]: inst.value
                for labels, inst in self._c_recoveries.series()
            },
            "pump": "pipelined" if self.config.pipeline else "sync",
            "pipeline_depth": self._g_pipeline_depth.value,
            "device_idle_seconds": self._c_device_idle.value,
            "spilled_sessions": (
                self._spill.spilled_count() if self._spill is not None else 0
            ),
            "snapshot_seconds": self._snapshot_s_total,
            "spill_errors": self._c_spill_errors.value,
            "stream_watchers": int(self._g_stream_watchers.value),
            "stream_frames_total": int(self._c_stream_frames.value),
            "stream_frame_gaps_total": int(self._c_stream_gaps.value),
            "queue_wait_p50": self._h_queue_wait.quantile(0.5),
            "queue_wait_p95": self._h_queue_wait.quantile(0.95),
            "queue_wait_p99": self._h_queue_wait.quantile(0.99),
            "completion_p50": self._h_latency.quantile(0.5),
            "completion_p95": self._h_latency.quantile(0.95),
            "rejections": self._c_rejections.value,
            "sessions": len(self.store),
            "queued": self.store.count(SessionState.QUEUED),
            "running": self.store.count(SessionState.RUNNING),
            "done": self.store.count(SessionState.DONE),
            "failed": self.store.count(SessionState.FAILED),
            "cancelled": self.store.count(SessionState.CANCELLED),
            "rounds": self._rounds,
            "steps_advanced": self._steps_total,
            "steps_advanced_packed": self._steps_packed_total,
            # the per-key stencil stamp (docs/RULES.md): which counting
            # path each live CompileKey compiled, and the matmul count
            "matmul_keys": int(self._g_matmul_keys.value),
            "stencil_keys": {
                _key_bucket(k): e.stencil
                for k, e in self.scheduler.engines.items()
                if getattr(e, "stencil", None) is not None
            },
            # the mesh tier (docs/SERVING.md "Mega-board sessions"):
            # sessions currently sharded over the reserved slice
            "mesh_sessions": int(self._g_mesh_sessions.value),
            # tenant QoS (docs/SERVING.md "Tenant QoS"): live sessions
            # and typed sheds per tenant — {} on policy-less services,
            # so the stats shape only grows when a policy exists
            **(
                {
                    "tenants": self.store.live_by_tenant(),
                    "tenant_sheds": {
                        f"{labels['tenant']}:{labels['reason']}": int(
                            inst.value
                        )
                        for labels, inst in self._c_tenant_shed.series()
                    },
                }
                if self._qos is not None
                else {}
            ),
            "elapsed_s": elapsed,
            "sessions_per_sec": self._completed / elapsed if elapsed > 0 else 0.0,
            "batch_occupancy_mean": self._occupancy_sum / self._rounds
            if self._rounds
            else 0.0,
            "compile_counts": {
                repr(k): v for k, v in self.scheduler.compile_counts().items()
            },
        }


def _key_bucket(key: CompileKey) -> str:
    """The bounded label a CompileKey becomes in the registry:
    ``rule:HxW:backend`` — small closed sets by construction."""
    h, w = key.shape
    return f"{key.rule.name}:{h}x{w}:{key.backend}"
