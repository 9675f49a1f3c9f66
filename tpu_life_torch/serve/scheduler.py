"""Admission and slot scheduling: the queue/engine split.

The MPMD-serving lesson (PAPERS.md, arXiv:2412.14374) is to separate
request *ingestion* from device *stepping*: requests land in a bounded
FIFO queue, a scheduling round moves compatible sessions into batch
slots, and the engines advance whatever is resident.  Policies:

- **Backpressure**: the queue is bounded (``max_queue``); an enqueue past
  capacity raises :class:`~tpu_life_torch.serve.errors.QueueFull` *before* the
  session is stored, so a misbehaving client cannot grow memory.
- **Admission**: sessions are grouped by :class:`CompileKey`; each key
  lazily gets one engine with ``capacity`` slots.  Within a key the order
  is strict FIFO; across keys the queue is scanned in submission order so
  a full engine for one key never head-of-line-blocks another key's
  sessions (per-key FIFO, globally work-conserving).
- **Deadline-aware eviction**: a session past its deadline is failed with
  :class:`SessionTimeout` wherever it is — dropped from the queue, or
  evicted from its running slot so the batch's capacity goes back to
  tenants that can still meet theirs.
- **Per-slot failure isolation**: a failing session (the ``fault_at``
  drill, or any RECOVERABLE error surfacing during its slot operations —
  ``runtime.recovery`` semantics) marks only that session FAILED and
  frees its slot; the rest of the batch keeps stepping.

Two round shapes share these policies:

- :meth:`Scheduler.round` — the classic host-synchronous quantum
  (admit -> advance -> retire, each engine's chunk awaited in place).
  This is the oracle the pipelined pump is bit-compared against.
- :meth:`Scheduler.round_begin` / :meth:`Scheduler.round_end` — the
  pipelined round the service drives in three phases (docs/SERVING.md):
  *begin* (locked) expires, admits, and async-dispatches one chunk per
  engine in rotated key order — so a mixed-rule population round-robins
  its compiled steps and a slow or faulted key never head-of-line-blocks
  another key's pipeline; *settle* (run by the service OUTSIDE its lock)
  lets device chunks and host-engine compute finish; *end* (locked)
  retires the PREVIOUS dispatch's finishers from the engines' double
  buffers, re-admits into the freed slots, and late-dispatches engines
  that were empty at begin.  Retirement lags dispatch by one round by
  construction — that lag is the overlap.  Per-key in-flight tracking
  (``pending`` / each engine's own in-flight chunk) keeps the keys'
  pipelines independent.  Verb-triggered slot releases that land while
  an engine is settling outside the lock are parked in ``deferred`` and
  applied at the next begin — verbs never mutate an engine mid-compute.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from tpu_life_torch import obs
from tpu_life_torch.runtime import recovery
from tpu_life_torch.runtime.metrics import log
from tpu_life_torch.serve.engine import (
    CompileKey,
    EngineBase,
    make_engine,
    make_host_engine,
)
from tpu_life_torch.serve.errors import QueueFull, SessionTimeout
from tpu_life_torch.serve.sessions import Session, SessionState


def _slot_attrs(slots: dict) -> dict:
    """Per-slot trace attributes for a dispatch/step span — WHICH
    sessions (and which distributed traces) this device chunk advanced.
    Guarded by the one-global-check discipline: with no active tracer
    this is a single ``None`` test and allocates nothing."""
    if not obs.tracing():
        return {}
    return {
        "sids": [s.sid for s in slots.values()],
        "trace_ids": sorted(
            {s.trace_id for s in slots.values() if s.trace_id is not None}
        ),
    }


@dataclass
class RoundStats:
    """What one scheduling round did — the metrics payload."""

    admitted: int = 0
    completed: int = 0
    failed: int = 0
    evicted: int = 0
    # in-place engine recoveries this round (docs/SERVING.md "Resource
    # governance"): a chunk fault that was masked instead of failing a key
    engine_recoveries: int = 0
    steps_advanced: int = 0
    # the slice of steps_advanced run by bitplane-packed engines — the
    # per-round attribution `tpu-life stats` splits throughput on
    steps_advanced_packed: int = 0
    queue_depth: int = 0
    occupancy: int = 0  # occupied slots across engines after the round
    slots: int = 0  # total allocated slots across engines


@dataclass
class Scheduler:
    capacity: int = 8  # batch slots per engine (per compile key)
    chunk_steps: int = 16  # device steps per host-sync scheduling round
    max_queue: int = 64  # bounded admission queue (backpressure)
    # the stochastic tier's bitplane knob (ServeConfig.mc_packed): ising
    # batches run on the packed device engine unless pinned off
    mc_packed: bool = True
    # tenant QoS (docs/SERVING.md "Tenant QoS"): when set (duck-typed —
    # anything with ``admission_order(sessions, cursor)``), the admit
    # scan orders the queue by deficit-round-robin over tenants instead
    # of plain FIFO, so one hog tenant cannot starve the rest of batch
    # slots.  None keeps the exact FIFO scan, byte for byte.
    qos: object | None = None
    # in-place recovery budget (docs/SERVING.md "Resource governance"):
    # how many chunk-level RECOVERABLE faults per CompileKey are masked
    # by rebuild-and-replay before falling back to the typed failure.
    # 0 restores the pure failure-isolating behavior.
    engine_max_restarts: int = 3
    clock: object = time.monotonic
    # the device the device engines run on (ServeConfig.device): None is
    # the current card, "cpu" the plain PyTorch versions on the host
    device: object | None = None

    queue: deque = field(default_factory=deque)
    engines: dict = field(default_factory=dict)  # CompileKey -> EngineBase
    running: dict = field(default_factory=dict)  # CompileKey -> {slot: Session}
    # telemetry observer (duck-typed; the service implements it): notified
    # on admission (with the measured queue wait) and on every terminal
    # transition the scheduler performs (with the submit-to-finish latency)
    observer: object | None = None
    # pipelined-round state: sessions that finished inside an already-
    # dispatched chunk, awaiting retirement once that chunk settles
    # (CompileKey -> [(slot, Session)]) ...
    pending: dict = field(default_factory=dict)
    # ... the finishers of the round currently being built ...
    _fresh: dict = field(default_factory=dict)
    # ... slot releases parked while their engine settles outside the
    # service lock (a cancel must not race an engine mid-compute), and
    # the key-rotation cursor for round-robin dispatch order
    deferred: list = field(default_factory=list)
    _rotation: int = 0
    # the in-place recovery ladder's per-key state (docs/SERVING.md
    # "Resource governance"): recoveries consumed, a halved chunk size
    # (the first OOM rung), keys demoted to the host executor (the
    # second), and the degraded_reason stamped onto their sessions
    restarts: dict = field(default_factory=dict)
    chunk_override: dict = field(default_factory=dict)
    demoted: set = field(default_factory=set)
    degraded: dict = field(default_factory=dict)

    # -- ingestion ---------------------------------------------------------
    def ensure_admission(self) -> None:
        """Raise :class:`QueueFull` when the bounded queue is at capacity.

        Exposed separately so the service can reject a submission *before*
        constructing and storing the session — backpressure that bounds
        memory, not just slots.
        """
        if len(self.queue) >= self.max_queue:
            raise QueueFull(
                f"admission queue full ({self.max_queue} sessions queued); "
                f"retry after the batch drains"
            )

    def enqueue(self, session: Session) -> None:
        self.ensure_admission()
        self.queue.append(session)

    def remove_queued(self, session: Session) -> bool:
        try:
            self.queue.remove(session)
            return True
        except ValueError:
            return False

    def evict_running(self, session: Session) -> bool:
        """Free a RUNNING session's slot (cancel / deadline); the caller
        sets the session's terminal state.  While the slot's engine is
        settling outside the service lock the release is parked in
        ``deferred`` (applied at the next round's begin) — touching an
        engine mid-compute from a verb thread would race the pump."""
        for key, slots in self.running.items():
            for slot, s in list(slots.items()):
                if s is session:
                    del slots[slot]
                    engine = self.engines[key]
                    if engine.busy:
                        self.deferred.append((key, slot))
                    else:
                        engine.release(slot)
                    return True
        return False

    def _process_deferred(self) -> None:
        for key, slot in self.deferred:
            engine = self.engines.get(key)
            if engine is not None:
                engine.release(slot)
        self.deferred.clear()

    # -- mid-run steering (docs/STREAMING.md "Edits") -----------------------
    def _load_budget(self, s: Session) -> int:
        """The step budget a slot load may carry: the session's remaining
        steps, capped at the next scheduled edit's boundary so the slot
        FREEZES exactly there (``remaining == 0`` is the engines' own
        freeze mask) whatever the chunk cadence — the seam a resumed
        edit log re-applies through at bit-exact positions."""
        budget = s.steps_remaining
        if s.scheduled_edits:
            abs_done = s.start_step + s.steps_done
            budget = min(budget, max(0, s.scheduled_edits[0][0] - abs_done))
        return budget

    def apply_edits(self, stats: RoundStats | None = None) -> int:
        """Drain verb-queued cell edits (``pending_edits``) and due
        scheduled edits into their sessions' slots, between chunks.

        Runs at the top of both round shapes, before any dispatch: for
        each key with an edit due, the in-flight chunk (if any) is
        collected — an edit is a sync point for ITS key only; other
        keys' pipelines never notice — then the slot's materialized
        board is peeked, mutated, and reloaded at the same absolute
        position (the freeze-mask seam: collect -> peek -> mutate ->
        load).  Scheduled edits log at their ORIGINAL recorded step,
        verb edits at the current materialized step; both land in
        ``s.edits``, the log the spill manifest persists and the replay
        oracle re-executes.  Returns how many log entries were applied.
        """
        stats = stats if stats is not None else RoundStats()
        applied = 0
        for key in list(self.running):
            slots = self.running.get(key)
            engine = self.engines.get(key)
            if not slots or engine is None:
                continue
            due = [
                (slot, s)
                for slot, s in list(slots.items())
                if s.pending_edits
                or (
                    s.scheduled_edits
                    and s.scheduled_edits[0][0] <= s.start_step + s.steps_done
                )
            ]
            if not due:
                continue
            if engine.inflight:
                try:
                    engine.collect_chunk()
                except recovery.RECOVERABLE as e:
                    # the chunk under the edit died: recover the key in
                    # place; the edits stay pending and apply next round
                    # against the rebuilt engine's replayed boards
                    self.recover_engine(key, e, stats)
                    continue
            for slot, s in due:
                if slots.get(slot) is not s:
                    continue  # evicted/cancelled while collecting
                try:
                    board, lag = engine.peek_slot(slot)
                except recovery.RECOVERABLE as e:
                    self.recover_engine(key, e, stats)
                    break
                # lag is 0 after the collect above; rewind defensively so
                # the log step always names a materialized board
                s.steps_done -= lag
                board = np.array(board, copy=True)
                abs_done = s.start_step + s.steps_done
                entries = []
                while (
                    s.scheduled_edits
                    and s.scheduled_edits[0][0] <= abs_done
                ):
                    entries.append(s.scheduled_edits.pop(0))
                entries.extend((abs_done, cells) for cells in s.pending_edits)
                s.pending_edits.clear()
                hook = getattr(self.observer, "session_edited", None)
                for step, cells in entries:
                    for r, c, v in cells:
                        board[r, c] = v
                    s.edits.append((step, cells))
                    applied += 1
                    if hook is not None:
                        hook(s, step, cells)
                try:
                    engine.load(
                        slot,
                        board,
                        self._load_budget(s),
                        seed=s.seed,
                        temperature=s.temperature,
                        start_step=abs_done,
                    )
                except recovery.RECOVERABLE as e:
                    del slots[slot]
                    engine.release(slot)
                    s.fail(f"edit reload failed: {type(e).__name__}: {e}")
                    self._notify_finished(s)
                    stats.failed += 1
        return applied

    # -- one scheduling round ---------------------------------------------
    def round(self, keyer) -> RoundStats:
        """Expire deadlines, admit from the queue, advance every engine one
        chunk, retire finished slots.  ``keyer(session) -> CompileKey``.
        """
        stats = RoundStats()
        self.apply_edits(stats)
        now = self.clock()
        with obs.span("serve.admit"):
            self._expire(now, stats)
            self._admit(keyer, stats)
        # occupancy is sampled when the batch STEPS (post-admit, pre-
        # advance): sampling after retirement would report an always-empty
        # batch whenever sessions finish within one round
        stats.occupancy = sum(e.occupancy() for e in self.engines.values())
        stats.slots = sum(e.capacity for e in self.engines.values())
        self._advance(stats)
        stats.queue_depth = len(self.queue)
        return stats

    def _expire(self, now: float, stats: RoundStats) -> None:
        # queued sessions past deadline: drop before they ever cost a slot
        for s in [s for s in self.queue if s.deadline is not None and now >= s.deadline]:
            self.queue.remove(s)
            e = SessionTimeout(
                f"deadline expired after {s.steps_done} steps (queued)"
            )
            s.fail(f"{type(e).__name__}: {e}")
            self._notify_finished(s)
            stats.failed += 1
            log.info("serve: session %s timed out in queue", s.sid)
        # running sessions past deadline: evict — their slot goes back to
        # tenants that can still meet their deadlines
        for key, slots in self.running.items():
            for slot, s in list(slots.items()):
                if s.steps_remaining == 0:
                    # fully computed, awaiting retirement (the pipelined
                    # pump retires one round after dispatch): under the
                    # sync pump this session retired DONE in its final
                    # round, so failing it here would make the overlap
                    # change an outcome — the one thing it must never do
                    continue
                if s.deadline is not None and now >= s.deadline:
                    del slots[slot]
                    self.engines[key].release(slot)
                    e = SessionTimeout(
                        f"deadline expired after {s.steps_done} steps (running)"
                    )
                    s.fail(f"{type(e).__name__}: {e}")
                    self._notify_finished(s)
                    stats.failed += 1
                    stats.evicted += 1
                    log.info("serve: session %s evicted (deadline)", s.sid)

    def _admit_order(self) -> list:
        """Drain the queue into this round's admission scan order: FIFO
        without a QoS policy; deficit-round-robin over tenants with one
        (per-tenant FIFO preserved — only the interleave changes).  The
        rotation cursor reuses the dispatch rotation counter so tenant
        ties don't always break toward the same name."""
        order = list(self.queue)
        self.queue.clear()
        if self.qos is not None and order:
            order = self.qos.admission_order(order, cursor=self._rotation)
        return order

    def _admit(self, keyer, stats: RoundStats) -> None:
        deferred = []
        for s in self._admit_order():
            key = keyer(s)
            engine = self.engines.get(key)
            if engine is None:
                try:
                    engine = self._build_engine(key)
                except recovery.RECOVERABLE as e:
                    # an engine build that OOMs (device_put of the batch,
                    # a first allocation) must fail only this key's
                    # admit, typed — never escape into the pump.  Later
                    # queued sessions of the same key each retry (and
                    # fail) their own admit.
                    s.fail(f"engine build failed: {type(e).__name__}: {e}")
                    self._notify_finished(s)
                    stats.failed += 1
                    log.warning(
                        "serve: engine build for %r failed at admit: %s",
                        key, e,
                    )
                    continue
                self.engines[key] = engine
                self.running[key] = {}
            slot = engine.acquire()
            if slot is None:
                # this key's batch is full: defer, keep scanning.  Later
                # sessions of the SAME key also find it full and defer in
                # order (per-key FIFO holds); other keys stay unblocked.
                deferred.append(s)
                continue
            try:
                loader = getattr(s, "mesh_resume", None)
                if loader is not None and hasattr(engine, "load_tiles"):
                    # shard-wise mega-board resume (docs/SERVING.md
                    # "Mega-board sessions"): the session carries a tile
                    # block loader instead of a board — each destination
                    # shard pulls its own rectangle at load, possibly
                    # onto a different mesh shape than the one that
                    # spilled (arXiv 2112.01075).  Consumed once: a
                    # later re-admit (engine recovery) reloads from the
                    # engine's own salvaged state like any session.
                    engine.load_tiles(
                        slot,
                        loader,
                        self._load_budget(s),
                        start_step=s.start_step + s.steps_done,
                    )
                    s.mesh_resume = None
                else:
                    # seed/temperature are the stochastic per-slot state
                    # (validated at submit); deterministic engines ignore
                    # them.  start_step re-enters the counter-based PRNG
                    # stream at the session's absolute position — the
                    # resumed-after-failover case (start_step > 0) is
                    # bit-exact by construction
                    engine.load(
                        slot,
                        s.board,
                        self._load_budget(s),
                        seed=s.seed,
                        temperature=s.temperature,
                        start_step=s.start_step + s.steps_done,
                    )
            except recovery.RECOVERABLE as e:
                engine.release(slot)
                s.fail(f"load failed: {e}")
                self._notify_finished(s)
                stats.failed += 1
                continue
            s.state = SessionState.RUNNING
            s.slot = slot
            # the path stamp (docs/OBSERVABILITY.md): which storage layout
            # steps this session — echoed in views and round attribution
            s.packed = engine.packed
            s.lanes = engine.lanes
            # a key degraded by the OOM ladder stamps every later tenant
            # too: the operator sees WHICH sessions ran on the fallback
            reason = self.degraded.get(key)
            if reason is not None:
                s.degraded_reason = reason
            s.admitted_at = self.clock()
            if self.observer is not None:
                self.observer.session_admitted(
                    s, max(0.0, s.admitted_at - s.submitted_at)
                )
            self.running[key][slot] = s
            stats.admitted += 1
        self.queue.extend(deferred)

    def _fault_drill(self, engine: EngineBase, slots: dict, stats: RoundStats) -> None:
        # the fault-injection drill fires where a real per-slot device
        # failure would: before the chunk that crosses fault_at.  Only
        # the faulty tenant dies; its slot frees, the batch continues.
        for slot, s in list(slots.items()):
            to_run = min(engine.chunk_steps, s.steps_remaining)
            if not (s.fault_at and s.steps_done < s.fault_at <= s.steps_done + to_run):
                continue
            e = recovery.InjectedFault(
                f"injected per-slot device failure crossing step {s.fault_at}"
            )
            assert isinstance(e, recovery.RECOVERABLE)
            del slots[slot]
            engine.release(slot)
            s.fail(f"{type(e).__name__}: {e}")
            self._notify_finished(s)
            stats.failed += 1
            log.info("serve: session %s failed in slot %d: %s", s.sid, slot, e)

    def _build_engine(self, key) -> EngineBase:
        """The key's engine, honoring the recovery ladder's per-key state:
        a halved chunk after the first OOM, the host executor after the
        second — so a rebuilt (or re-minted, after release_idle_engines)
        engine for a degraded key stays degraded instead of re-OOMing."""
        chunk = self.chunk_override.get(key, self.chunk_steps)
        if key in self.demoted:
            return make_host_engine(key, self.capacity, chunk)
        return make_engine(
            key, self.capacity, chunk, mc_packed=self.mc_packed, device=self.device
        )

    def _notify_recovery(self, key, outcome: str) -> None:
        hook = getattr(self.observer, "engine_recovered", None)
        if hook is not None:
            hook(key, outcome)

    def recover_engine(self, key, exc, stats: RoundStats | None = None) -> bool:
        """In-place engine recovery after a chunk-level RECOVERABLE fault
        (docs/SERVING.md "Resource governance"): instead of failing the
        key's tenants typed, rebuild the engine and replay.

        Every resident session's newest *materialized* state is salvaged
        (``engine.salvage_slot``: the double buffer plus the in-flight /
        lost chunk's lag), its bookkeeping rewound by the lag, and the
        session reloaded into a fresh engine at the exact absolute
        position (``start_step + steps_done`` — the counter-based MC
        streams re-enter bit-identically, deterministic rules are pure
        functions of the board, and chunk invariance is already proven).
        A session whose compute is both finished AND materialized
        retires DONE right here.  A device OOM takes the **fallback
        ladder**: the first OOM halves the key's chunk (smaller scan
        footprint, same trajectory), a second demotes the key to the
        bit-identical host executor; both stamp ``degraded_reason`` on
        the key's sessions.  Only a device OOM takes the ladder: a FATAL
        error (no card, a kernel that does not build) never reads as one
        (``recovery.is_oom``), so no demotion stands in for the device or
        a kernel.  ``engine_max_restarts`` bounds recoveries per key —
        past it (or with the budget set to 0) the fault falls back to
        today's typed failure.  Returns True when the key was recovered
        in place."""
        stats = stats if stats is not None else RoundStats()
        error = f"{type(exc).__name__}: {exc}"
        engine = self.engines.get(key)
        slots = self.running.get(key)
        if engine is None or slots is None:
            return False
        used = self.restarts.get(key, 0) + 1
        self.restarts[key] = used
        if used > self.engine_max_restarts:
            self._notify_recovery(key, "budget_exhausted")
            self.fail_engine_sessions(key, error, stats)
            return False
        outcome = "replayed"
        if recovery.is_oom(exc) and key not in self.demoted:
            if key in self.chunk_override:
                # the halved chunk still OOMed: demote to the host twin —
                # sessions finish (slower) instead of failing typed
                self.demoted.add(key)
                outcome = "oom_host_demoted"
            else:
                self.chunk_override[key] = max(1, engine.chunk_steps // 2)
                outcome = "oom_halved_chunk"
            self.degraded[key] = outcome
        # salvage each resident session's newest trustworthy state; a
        # slot whose board cannot materialize (poisoned device buffer)
        # is genuinely lost and fails typed like before
        salvaged: list = []
        lost = 0
        for slot, s in list(slots.items()):
            del slots[slot]
            try:
                board, lag = engine.salvage_slot(slot)
            except recovery.RECOVERABLE as e2:
                s.fail(
                    f"salvage failed: {error} "
                    f"(then {type(e2).__name__}: {e2})"
                )
                self._notify_finished(s)
                stats.failed += 1
                lost += 1
                continue
            salvaged.append((s, board, lag))
        # condemn the old engine with its per-key transient state; parked
        # releases for this key are for already-evicted sessions — moot
        # against a fresh engine's clean slot pool
        self.pending.pop(key, None)
        self._fresh.pop(key, None)
        self.deferred = [(k, sl) for (k, sl) in self.deferred if k != key]
        try:
            new_engine = self._build_engine(key)
        except recovery.RECOVERABLE as e2:
            # the rebuild itself failed — e.g. the replacement batch
            # allocation OOMs while the condemned engine's buffers are
            # still alive.  The recovery path must NEVER let that escape
            # into the pump (it would kill the worker the governor
            # exists to keep alive): the salvaged sessions fall back to
            # the typed failure, the old engine stays registered for
            # future admissions (its slots are all free), and its lost
            # accounting is cleared like any typed-failure path.
            for s, _board, _lag in salvaged:
                s.fail(
                    f"recovery rebuild failed: {error} "
                    f"(then {type(e2).__name__}: {e2})"
                )
                self._notify_finished(s)
                stats.failed += 1
            engine.clear_lost()
            self._notify_recovery(key, "rebuild_failed")
            log.error(
                "serve: engine %r recovery REBUILD failed (%s after %s); "
                "%d session(s) failed typed",
                key, e2, error, len(salvaged),
            )
            return False
        self.engines[key] = new_engine
        reason = self.degraded.get(key)
        reloaded = retired = 0
        for s, board, lag in salvaged:
            # rewind to the materialized step: the lag steps were
            # accounted at dispatch but never materialized — the rebuilt
            # engine re-runs exactly them
            s.steps_done -= lag
            if reason is not None:
                s.degraded_reason = reason
            if s.steps_remaining == 0:
                # finished AND materialized (a pending finisher with zero
                # lag): its board is final — retire it DONE, the outcome
                # the sync pump already settled a round earlier
                s.finish(board)
                self._notify_finished(s)
                stats.completed += 1
                retired += 1
                continue
            slot = new_engine.acquire()
            try:
                new_engine.load(
                    slot,
                    board,
                    self._load_budget(s),
                    seed=s.seed,
                    temperature=s.temperature,
                    start_step=s.start_step + s.steps_done,
                )
            except recovery.RECOVERABLE as e2:
                new_engine.release(slot)
                s.fail(f"recovery reload failed: {type(e2).__name__}: {e2}")
                self._notify_finished(s)
                stats.failed += 1
                continue
            s.slot = slot
            s.packed = new_engine.packed
            s.lanes = new_engine.lanes
            slots[slot] = s
            reloaded += 1
        stats.engine_recoveries += 1
        self._notify_recovery(key, outcome)
        log.warning(
            "serve: engine %r recovered in place (%s, attempt %d/%d): "
            "%d session(s) replaying, %d retired, %d unsalvageable — %s",
            key, outcome, used, self.engine_max_restarts,
            reloaded, retired, lost, error,
        )
        return True

    def fail_engine_sessions(
        self, key, error: str, stats: RoundStats | None = None
    ) -> int:
        """Fail the resident sessions of ONE engine after a chunk-level
        RECOVERABLE fault (dispatch or collect raised) — with one
        carve-out: sessions whose compute ALREADY finished in an earlier
        chunk (this key's ``pending`` finishers, merely awaiting the
        one-round retirement lag) are RETIRED, not failed.  The sync
        pump retired them DONE a round ago, and the overlap must never
        change an outcome; their boards come from chunks that predate
        the fault, so collecting the engine's healthy in-flight chunk
        (if any) materializes them.  If that collect ALSO faults, their
        boards are genuinely unknowable and they fail with the rest.
        ``_fresh`` finishers stay failed: their chunk IS the one that
        died, so their final steps never materialized.  Every other key
        keeps stepping untouched — the batch-level analogue of the
        per-slot ``fault_at`` isolation: a device fault costs one key's
        tenants, never the pump and never a completed result."""
        stats = stats if stats is not None else RoundStats()
        engine = self.engines.get(key)
        slots = self.running.get(key, {})
        salvage = [
            (slot, s)
            for slot, s in self.pending.get(key, [])
            if slots.get(slot) is s
        ]
        if salvage and engine is not None and engine.inflight:
            try:
                engine.collect_chunk()
            except recovery.RECOVERABLE:
                salvage = []  # the settled boards are unreachable too
        for slot, s in salvage:
            self._retire_slot(engine, slots, slot, s, stats)
        failed = 0
        for slot, s in list(slots.items()):
            del slots[slot]
            if engine is not None:
                engine.release(slot)
            s.fail(error)
            self._notify_finished(s)
            failed += 1
        self.pending.pop(key, None)
        self._fresh.pop(key, None)
        if engine is not None:
            # a lost chunk's accounting dies with its sessions: a stale
            # entry would misroute later peeks to the double buffer
            engine.clear_lost()
        stats.failed += failed
        if failed or salvage:
            log.warning(
                "serve: chunk fault on %r failed %d session(s), retired %d "
                "already-finished: %s",
                key, failed, len(salvage), error,
            )
        return failed

    def _retire_slot(
        self, engine: EngineBase, slots: dict, slot: int, s: Session,
        stats: RoundStats,
    ) -> None:
        del slots[slot]
        try:
            board = engine.fetch(slot)
        except recovery.RECOVERABLE as e:
            engine.release(slot)
            s.fail(f"fetch failed: {e}")
            self._notify_finished(s)
            stats.failed += 1
            return
        engine.release(slot)
        s.finish(board)
        self._notify_finished(s)
        stats.completed += 1

    def _advance(self, stats: RoundStats) -> None:
        for key, engine in self.engines.items():
            slots = self.running[key]
            if not slots:
                continue
            self._fault_drill(engine, slots, stats)
            if not slots:
                continue
            with obs.span(
                "serve.step-chunk",
                occupied=len(slots),
                steps=engine.chunk_steps,
                **_slot_attrs(slots),
            ):
                try:
                    advanced = engine.dispatch_chunk()
                except recovery.RECOVERABLE as e:
                    # a chunk-level device fault (the chaos engine.* drill,
                    # or any real launch/materialize failure): recovered
                    # IN PLACE — rebuild + replay under the restart
                    # budget, the OOM ladder when applicable — while the
                    # other keys' batches continue untouched; only an
                    # exhausted budget falls back to the typed failure
                    self.recover_engine(key, e, stats)
                    continue
                # account the dispatched steps BEFORE the collect — the
                # same order the pipelined pump uses — so a collect
                # fault's lost-chunk lag (engine.salvage_slot) rewinds
                # exactly what was accounted, under either pump
                for slot, n in advanced.items():
                    s = slots.get(slot)
                    if s is None:
                        continue  # slot freed above; engine already ignores it
                    s.steps_done += n
                    stats.steps_advanced += n
                    if engine.packed:
                        stats.steps_advanced_packed += n
                try:
                    engine.collect_chunk()
                except recovery.RECOVERABLE as e:
                    self.recover_engine(key, e, stats)
                    continue
            with obs.span("serve.retire"):
                for slot, s in list(slots.items()):
                    if s.steps_remaining == 0:
                        self._retire_slot(engine, slots, slot, s, stats)

    # -- the pipelined round (three phases; see the module docstring) -------
    def round_begin(self, keyer, stats: RoundStats) -> list:
        """Locked phase 1: apply parked releases, expire deadlines, admit,
        then async-dispatch one chunk per engine in rotated key order.
        Returns the settle plan — ``(key, engine, rolled)`` per engine that
        has in-flight or pending work — for the service to run outside its
        lock.  Sessions finishing inside a dispatched chunk are recorded
        in ``_fresh``; they retire at the NEXT round's end, once their
        chunk has settled behind its successor."""
        self._process_deferred()
        self.apply_edits(stats)
        now = self.clock()
        with obs.span("serve.admit"):
            self._expire(now, stats)
            self._admit(keyer, stats)
        stats.occupancy = sum(e.occupancy() for e in self.engines.values())
        stats.slots = sum(e.capacity for e in self.engines.values())
        plan = []
        keys = list(self.engines)
        if keys:
            # rotate the dispatch order so no key's chunk is always the
            # last launched — with several compiled programs sharing one
            # device queue, the tail position is the one that waits
            off = self._rotation % len(keys)
            self._rotation += 1
            keys = keys[off:] + keys[:off]
        for key in keys:
            engine = self.engines[key]
            slots = self.running[key]
            if not slots and not engine.inflight and not self.pending.get(key):
                continue
            self._fault_drill(engine, slots, stats)
            if engine.inflight and not engine.ASYNC_ROLL:
                # a host executor still carrying a late-dispatched chunk:
                # dispatching now would run that compute HERE, under the
                # lock — let settle collect it outside, and the end phase
                # launch the next one
                rolled = False
            else:
                rolled = self._dispatch_engine(
                    key, engine, slots, stats, self._fresh
                )
                # a dispatch fault recovered in place replaces the key's
                # engine: the settle plan must carry the LIVE engine, not
                # the condemned one (settling a condemned engine would
                # re-raise and burn another recovery)
                engine = self.engines[key]
            plan.append((key, engine, rolled))
        stats.queue_depth = len(self.queue)
        return plan

    def _dispatch_engine(
        self, key, engine: EngineBase, slots: dict, stats: RoundStats,
        sink: dict,
    ) -> bool:
        """Launch one async chunk on ``engine`` and account its steps to
        the resident sessions; True if a chunk was actually dispatched.
        Sessions the chunk finishes are recorded in ``sink`` — ``_fresh``
        for begin-phase dispatches (their chunk is this round's newest),
        ``pending`` for end-phase ones (the next settle materializes
        them, so they retire at the very next end)."""
        if not any(s.steps_remaining > 0 for s in slots.values()):
            return False
        with obs.span(
            "serve.dispatch",
            occupied=len(slots),
            steps=engine.chunk_steps,
            **_slot_attrs(slots),
        ):
            try:
                advanced = engine.dispatch_chunk()
            except recovery.RECOVERABLE as e:
                # launch-time fault — including the realistic first-
                # compile OOM of a brand-new key, raised HERE inside the
                # locked begin phase: recovered in place (rebuild +
                # replay, OOM ladder), never escaping into the pump; an
                # exhausted budget falls back to the typed failure
                self.recover_engine(key, e, stats)
                return False
        if not advanced:
            return False
        fresh = []
        for slot, n in advanced.items():
            s = slots.get(slot)
            if s is None:
                continue  # slot freed above; the chunk steps dead weight
            s.steps_done += n
            stats.steps_advanced += n
            if engine.packed:
                stats.steps_advanced_packed += n
            if s.steps_remaining == 0:
                fresh.append((slot, s))
        if fresh:
            sink.setdefault(key, []).extend(fresh)
        return True

    def round_end(self, keyer, stats: RoundStats, rolled: set) -> None:
        """Locked phase 3: retire the previous dispatches' finishers
        (their chunks settled in phase 2, so every fetch reads a
        materialized buffer), refill the freed slots from the queue, and
        late-dispatch engines that sat out phase 1 (``rolled`` names the
        keys that already launched a chunk this round — dispatching those
        again would double-step their sessions) — so the drain tail never
        costs a device-idle round per batch generation."""
        with obs.span("serve.retire"):
            for key, entries in list(self.pending.items()):
                engine = self.engines.get(key)
                if engine is None:
                    continue  # key released while its finishers waited
                slots = self.running[key]
                for slot, s in entries:
                    if slots.get(slot) is not s:
                        continue  # cancelled/expired meanwhile; handled there
                    self._retire_slot(engine, slots, slot, s, stats)
            self.pending = self._fresh
            self._fresh = {}
        with obs.span("serve.admit", phase="post-retire"):
            self._admit(keyer, stats)
        for key, engine in self.engines.items():
            slots = self.running[key]
            if slots and not engine.inflight and key not in rolled:
                self._dispatch_engine(key, engine, slots, stats, self.pending)
        stats.queue_depth = len(self.queue)

    def flush_inflight(self) -> None:
        """Collect every engine's in-flight chunk without running a new
        round — the drain tail's last act before close, so no device work
        is abandoned mid-air (e.g. when every session of a chunk was
        cancelled while it flew)."""
        for key, engine in self.engines.items():
            if engine.inflight:
                try:
                    engine.collect_chunk()
                except recovery.RECOVERABLE as e:
                    # the chunk died on its way out: any still-resident
                    # sessions fail typed instead of stranding the drain
                    self.fail_engine_sessions(key, f"{type(e).__name__}: {e}")

    def idle_seconds_delta(self) -> float:
        """Device-idle seconds accumulated across engines since last asked
        (the service drains this into its counter every round)."""
        return sum(e.idle_seconds_delta() for e in self.engines.values())

    def queue_age_oldest_s(self) -> float:
        """Wall age of the oldest still-queued session (0.0 when the
        queue is empty) — the head-of-line demand signal the sampled
        time series carries for the autoscaler: depth says how many are
        waiting, age says how badly the fleet is behind."""
        if not self.queue:
            return 0.0
        now = self.clock()
        return max(0.0, now - min(s.submitted_at for s in self.queue))

    def _notify_finished(self, session: Session) -> None:
        """Tell the observer a session the scheduler drove reached a
        terminal state, with its submit-to-finish latency."""
        if self.observer is not None:
            self.observer.session_finished(
                session, max(0.0, self.clock() - session.submitted_at)
            )

    def release_idle_engines(self) -> int:
        """Drop engines with no resident sessions; returns how many.

        Engines are created lazily per CompileKey and a long-lived service
        with varied client geometries would otherwise accumulate one
        (capacity, h, w) device batch + compiled program per key forever.
        Releasing an idle engine frees its device memory at the cost of a
        recompile if that key's traffic returns — so this is an explicit
        API for quiet periods, never called automatically mid-burst.
        """
        # a queued session for a released key just rebuilds the engine next
        # round (one recompile) — no need to scan the queue here.  Engines
        # mid-settle (the pump's unlocked window holds no service lock, so
        # this call CAN overlap it) are skipped: collecting or deleting one
        # under the pump would race its compute — next quiet call gets it.
        idle_keys = [
            k for k, slots in self.running.items()
            if not slots and not self.engines[k].busy
        ]
        for k in idle_keys:
            engine = self.engines[k]
            if engine.inflight:
                # don't strand a dispatched chunk mid-air (every session of
                # it was cancelled): wait it out before dropping the engine
                try:
                    engine.collect_chunk()
                except recovery.RECOVERABLE:
                    pass  # no residents by construction; the engine dies anyway
            del self.engines[k]
            del self.running[k]
            self.pending.pop(k, None)
            self._fresh.pop(k, None)
        return len(idle_keys)

    # -- introspection -----------------------------------------------------
    def idle(self) -> bool:
        # parked releases count as live work: one more begin phase applies
        # them, so a drain loop cannot exit with slots still held
        return (
            not self.queue
            and not self.deferred
            and all(not s for s in self.running.values())
        )

    def compile_counts(self) -> dict[CompileKey, int]:
        return {k: e.compile_count for k, e in self.engines.items()}
