"""Session migration: a dead worker's spilled sessions resume elsewhere.

The failure-masking half of durability (docs/FLEET.md).  Each worker
spills its live sessions through the checkpoint contract
(``serve.spill``) into a per-generation directory the supervisor chose
for it.  When a worker dies, the supervisor's exit hook hands the death
to a :class:`Migrator`, which:

1. marks the dead ``(worker, generation)`` MIGRATING — the router
   answers the victim's pinned sids with a typed 409 ``migrating`` (+
   ``Retry-After``) or a synthetic in-progress poll view, never a 410 —
2. reads the victim's intact spills (CRC-verified; a corrupt-but-right-
   sized snapshot demotes to its predecessor, a session with no intact
   snapshot is recorded ``spill_corrupt``),
3. re-submits each as a **resume request** (``resume_b64`` +
   ``start_step`` + remaining budget + seed/temperature) to a survivor —
   refusal-only retry, exactly the router's own no-duplicate rule, and
   through the same capacity-WEIGHTED balancer, so a rescued batch
   lands on survivors in proportion to their device slices — and
4. re-pins the ORIGINAL fleet sid onto the survivor's session (a STICKY
   pin: LRU churn evicts ordinary pins around it, because the sid
   string encodes the DEAD home and a parse-fallback would answer a
   spurious 410), so the unmodified client polls straight through
   the kill.

Placement interplay (docs/FLEET.md "Device placement"): the supervisor
re-applies the dead worker's env overlay verbatim when it respawns, so
the fresh generation re-enters the SAME device slice while its former
sessions finish on survivors — capacity returns without re-planning.

Bit-identity is inherited, not re-proven: deterministic rules are pure
functions of the board, and the MC tier's ``(seed, step, cell,
substream)`` key schedule plus ``start_step`` makes a mid-stream restart
re-enter the exact stream.

Double death: when a survivor dies mid- or post-migration, the sessions
it adopted migrate again — the ``alias`` map remembers which original
fleet sid each adopted session answers to, so a second hop re-pins the
sid the client actually holds.

Sessions that were never spilled (death between admission and the first
spill pass) stay lost: once the migration run completes, their sids
answer 410 ``worker_lost`` with ``reason: never_snapshotted`` — the
documented recovery-point bound of a K-round spill cadence.

Everything is injectable (``forward``, ``clock``, ``sleep``) so the
state machine unit-tests on fakes; the real wiring (``tpu_life_torch.fleet``)
hands it the router's forwarder and balancer.
"""

from __future__ import annotations

import base64
import json
import shutil
import threading
import time
from collections import OrderedDict
from pathlib import Path

from tpu_life_torch import chaos, obs
from tpu_life_torch.fleet.registry import fleet_sid
from tpu_life_torch.fleet.router import (
    REFUSAL_CODES,
    WorkerUnreachable,
    _error_code,
    _json_body as _json,
)
from tpu_life_torch.gateway.errors import backoff_delay
from tpu_life_torch.gateway.server import ROUTE_SESSIONS
from tpu_life_torch.io.codec import encode_board
from tpu_life_torch.runtime.metrics import log
from tpu_life_torch.serve.spill import (
    MeshSpillRecord,
    SpillRecord,
    read_mesh_sessions,
    read_spill_sessions,
)

#: Peer-router 503 codes that mean "definitively not admitted" — the
#: worker refusal set plus the router's own fleet-level refusal.
PEER_REFUSAL_CODES = REFUSAL_CODES | {"fleet_unavailable"}

#: Bound on remembered per-sid outcomes / aliases (a months-running
#: router must not grow without bound; an evicted outcome degrades to
#: ``never_snapshotted`` — still a truthful 410).
MAX_OUTCOMES = 100_000



def worker_spill_dir(root: str, name: str, generation: int) -> Path:
    """Where one worker incarnation spills: per-generation, so a respawn
    can never read (or clobber) its predecessor's sessions."""
    return Path(root) / f"{name}g{generation}"


def resume_request(rec: SpillRecord) -> dict:
    """The wire body that resumes one spilled session on a survivor."""
    body = {
        "rule": rec.rule,
        "steps": rec.remaining,
        "start_step": rec.step,
        "resume_b64": base64.b64encode(encode_board(rec.board)).decode("ascii"),
        "height": rec.height,
        "width": rec.width,
    }
    if rec.seed is not None:
        body["seed"] = rec.seed
    if rec.temperature is not None:
        body["temperature"] = rec.temperature
    if rec.timeout_s is not None:
        body["timeout_s"] = rec.timeout_s
    if rec.trace_id is not None:
        # trace continuity (docs/OBSERVABILITY.md "Distributed tracing"):
        # the manifest-persisted id rides the resume wire body, so the
        # survivor's session CONTINUES the dead worker's trace — one
        # trace_id across generations and hosts
        body["trace_id"] = rec.trace_id
    # steered-session continuity (docs/STREAMING.md): the applied edit
    # log (provenance — already baked into the spilled board), the
    # unapplied scheduled tail (the survivor re-applies it at the
    # recorded steps), and the delta-stream sequence floor (a
    # reconnected watcher's numbering stays gapless across the failover)
    if rec.edits:
        body["edits"] = rec.edits
    if rec.scheduled_edits:
        body["scheduled_edits"] = rec.scheduled_edits
    if rec.stream_seq:
        body["stream_seq"] = rec.stream_seq
    return body


def mesh_resume_request(rec: MeshSpillRecord) -> dict:
    """The wire body that resumes one mega-board tile-set session (docs/
    SERVING.md "Mega-board sessions"): a ``resume_tiles_dir`` POINTER
    instead of ``resume_b64`` — the board never rides the wire, the
    survivor re-gathers it shard by shard from the shared spill root.
    This is why mesh rescues are local-plane only: a peer control plane
    on another host cannot see the directory."""
    body = {
        "rule": rec.rule,
        "steps": rec.remaining,
        "start_step": rec.step,
        "resume_tiles_dir": str(rec.root),
        "height": rec.height,
        "width": rec.width,
    }
    if rec.timeout_s is not None:
        body["timeout_s"] = rec.timeout_s
    if rec.trace_id is not None:
        body["trace_id"] = rec.trace_id
    if rec.scheduled_edits:
        body["scheduled_edits"] = rec.scheduled_edits
    if rec.stream_seq:
        body["stream_seq"] = rec.stream_seq
    return body


class Migrator:
    """Owns the migration state machine and the per-death worker threads."""

    def __init__(
        self,
        *,
        spill_root: str | None = None,
        supervisor,
        sessions,
        registry,
        balancer,
        forward,
        clock=time.monotonic,
        sleep=time.sleep,
        timeout_s: float = 30.0,
        retry_pause_s: float = 0.5,
        max_retry_pause_s: float = 5.0,
        stuck_after_s: float = 120.0,
        spill_url: str | None = None,
        site: str = "",
        peers: tuple[str, ...] = (),
    ):
        self.spill_root = spill_root
        #: remote spill store (docs/FLEET.md "Cross-host topology"): read
        #: a dead worker's sessions out of the shared HTTP store instead
        #: of a local directory — the rescue works when the survivor is
        #: on another machine.  ``site`` prefixes this control plane's
        #: namespaces in a SHARED store.
        self.spill_url = spill_url
        self.site = site
        #: peer control planes: when every LOCAL survivor refuses a
        #: resume, re-submit to a peer fleet's router — the session then
        #: answers its ORIGINAL sid through the peer proxy.
        self.peers = tuple(peers)
        self.supervisor = supervisor
        self.sessions = sessions
        self.balancer = balancer
        self.forward = forward
        self.clock = clock
        self.sleep = sleep
        self.timeout_s = timeout_s
        self.retry_pause_s = retry_pause_s
        self.max_retry_pause_s = max_retry_pause_s
        # the stuck-MIGRATING watchdog (docs/CHAOS.md): a migration run
        # that neither finishes nor fails — its thread died, or the exit
        # hook never fired — must not leave sids answering synthetic
        # in-progress views forever.  Past this deadline WITHOUT
        # PROGRESS (a live run heartbeats after every record it settles,
        # so the clock bounds one record's stall, not the whole run —
        # keep it comfortably above ``timeout_s``) a still-pending sid
        # settles to a terminal 410 ``migration_failed``.
        self.stuck_after_s = stuck_after_s
        self._lock = threading.Lock()
        # (worker, generation) -> when its migration run was activated
        self._active: dict[tuple[str, int], float] = {}
        self._completed: set[tuple[str, int]] = set()
        # fsid -> when the no-record "rescue imminent" fallback first
        # answered migrating for it (the watchdog's clock for deaths
        # whose exit hook never arrives)
        self._pending_since: OrderedDict[str, float] = OrderedDict()
        # fsid -> terminal non-migrated reason (spill_corrupt / migration_failed)
        self._failed: OrderedDict[str, str] = OrderedDict()
        # (worker, generation, worker-sid) -> the ORIGINAL fleet sid a
        # client holds — consulted on double death so a second hop
        # re-pins the sid that is actually out there
        self._alias: OrderedDict[tuple[str, int, str], str] = OrderedDict()
        # fsid -> (peer router url, peer fleet sid): sessions rescued
        # onto a PEER control plane; the router proxies these
        self._peer_pins: OrderedDict[str, tuple[str, str]] = OrderedDict()
        # fsid -> (steps_total, steps_done) from the spill manifest, for
        # synthetic poll views while the migration is in flight
        self._progress: dict[str, tuple[int, int]] = {}
        self._threads: list[threading.Thread] = []
        self._c_migrations = registry.counter(
            "fleet_migrations_total",
            "sessions handled by worker-death migration, by outcome",
            labels=("outcome",),
        )
        for outcome in ("migrated", "peer", "corrupt", "failed", "disabled"):
            self._c_migrations.labels(outcome=outcome)

    # -- the supervisor hook (called under its lock: must be fast) ----------
    def worker_exit(self, name: str, generation: int) -> None:
        key = (name, generation)
        with self._lock:
            if key in self._active or key in self._completed:
                return
            self._active[key] = self.clock()
        # chaos seam (docs/CHAOS.md): the migration thread dies before it
        # ever runs — the run is recorded ACTIVE but nothing will finish
        # it.  Without the stuck watchdog this leaves every victim sid
        # answering synthetic in-progress views forever; the drill arms
        # this point and asserts they settle to 410 migration_failed.
        if chaos.decide("migrate.die") is not None:
            chaos.record_fire("migrate.die", "die")
            log.error(
                "chaos: migration thread for %s gen %d killed at birth",
                name,
                generation,
            )
            return
        t = threading.Thread(
            target=self._run,
            args=(name, generation),
            name=f"fleet-migrate-{name}g{generation}",
            daemon=True,
        )
        # prune finished runs: a months-running fleet with restart churn
        # must not retain one dead Thread object per worker death
        self._threads = [x for x in self._threads if x.is_alive()]
        self._threads.append(t)
        t.start()

    # -- the router's view --------------------------------------------------
    def status(self, fsid: str, pin, *, pending_ok: bool = True) -> tuple[str, ...]:
        """What a request for a sid whose pinned home is gone should get:
        ``("migrating",)`` or ``("lost", reason)``.

        ``pending_ok`` narrows the no-record fallback: True only when the
        pin targets the worker's CURRENT generation (the just-died,
        exit-hook-not-yet-fired window, where a rescue is imminent).  A
        pin into an unknown PAST generation — a sid from a previous fleet
        process, or a forged generation — has no rescue coming and must
        settle to a terminal 410, never poll as migrating forever.

        Both migrating answers carry the stuck watchdog: an ACTIVE run
        older than ``stuck_after_s`` (its thread died mid-flight), or a
        pending-fallback sid that has waited that long for an exit hook
        that never came, settles to a terminal 410 ``migration_failed``
        instead of polling as migrating until the end of time."""
        now = self.clock()
        with self._lock:
            reason = self._failed.get(fsid)
            if reason is not None:
                return ("lost", reason)
            key = (pin.worker, pin.generation)
            started = self._active.get(key)
            if started is not None:
                if now - started <= self.stuck_after_s:
                    return ("migrating",)
            elif key in self._completed:
                # the run finished and neither re-pinned nor failed this
                # sid: it was never spilled before the death
                return ("lost", "never_snapshotted")
            elif not pending_ok:
                return ("lost", "never_snapshotted")
            else:
                # the death has not reached the supervisor's exit hook yet
                # (the monitor tick is on its way): migration is imminent —
                # but start (and bound) the watchdog clock for this sid
                first = self._pending_since.setdefault(fsid, now)
                while len(self._pending_since) > MAX_OUTCOMES:
                    self._pending_since.popitem(last=False)
                if now - first <= self.stuck_after_s:
                    return ("migrating",)
        # the watchdog tripped: whatever was meant to settle this sid is
        # presumed dead — record the terminal verdict (outside the lock;
        # _record_failure re-acquires it) so every later request is a
        # fast, consistent 410
        log.warning(
            "fleet: migration of %s stuck past %.0fs; settling to "
            "migration_failed (watchdog)",
            fsid,
            self.stuck_after_s,
        )
        self._record_failure(fsid, "migration_failed")
        return ("lost", "migration_failed")

    def progress(self, fsid: str) -> tuple[int, int] | None:
        with self._lock:
            return self._progress.get(fsid)

    def peer_of(self, fsid: str) -> tuple[str, str] | None:
        """``(peer router url, peer fleet sid)`` for a session rescued
        onto a peer control plane, else None — the router's proxy seam."""
        with self._lock:
            return self._peer_pins.get(fsid)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until every migration thread finished (tests, drains)."""
        deadline = time.monotonic() + timeout
        for t in list(self._threads):
            t.join(max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                return False
        return True

    # -- one worker-death migration run -------------------------------------
    def _run(self, name: str, generation: int) -> None:
        remote_ns = None
        d = None
        if self.spill_url is not None:
            # the wire read path (docs/FLEET.md "Cross-host topology"):
            # the victim's namespace in the shared store, site-prefixed —
            # identical triage to the directory read, CRC re-checked on
            # the downloaded bytes
            remote_ns = f"{self.site}{name}g{generation}"
        else:
            d = worker_spill_dir(self.spill_root, name, generation)
        cleanup = True
        try:
            try:
                if remote_ns is not None:
                    from tpu_life_torch.serve.spill_http import read_remote_sessions

                    # mesh tile sets never reach the remote store (the
                    # HTTP backend has no shard-wise contract — the
                    # worker marked those sessions spill-disabled, which
                    # lands in ``disabled`` below): nothing extra to read
                    records, corrupt, disabled = read_remote_sessions(
                        self.spill_url, remote_ns
                    )
                else:
                    records, corrupt, disabled = read_spill_sessions(d)
                    mrecs, mcorrupt, mdisabled = read_mesh_sessions(d)
                    records = list(records) + list(mrecs)
                    corrupt = list(corrupt) + list(mcorrupt)
                    disabled = list(disabled) + list(mdisabled)
            except Exception:
                # a read failure must not delete bytes nobody looked at
                log.exception("fleet: cannot read spills of %s gen %d", name,
                              generation)
                records, corrupt, disabled, cleanup = [], [], [], False
            log.info(
                "fleet: migrating %d session(s) from dead %s gen %d "
                "(%d corrupt, %d spill-disabled)",
                len(records),
                name,
                generation,
                len(corrupt),
                len(disabled),
            )
            obs.flight.record(
                "migrate.start",
                worker=name,
                generation=generation,
                sessions=len(records),
                corrupt=len(corrupt),
                disabled=len(disabled),
            )
            for sid in corrupt:
                self._record_failure(
                    self._target_fsid(name, generation, sid),
                    "spill_corrupt",
                    counter="corrupt",
                )
            for sid in disabled:
                # the worker itself degraded this session (a spill write
                # failed — ENOSPC): the truthful reason is the
                # degradation, not the misleading never_snapshotted
                self._record_failure(
                    self._target_fsid(name, generation, sid),
                    "spill_disabled",
                    counter="disabled",
                )
            # resolve every record's client-facing fsid and publish its
            # last-known progress BEFORE any resume runs: synthetic poll
            # views never regress to 0/0 while a session waits its turn
            targets = [
                (self._target_fsid(name, generation, rec.sid), rec)
                for rec in records
            ]
            with self._lock:
                for fsid, rec in targets:
                    self._progress[fsid] = (rec.steps_total, rec.step)
            # per-record isolation: a crash resuming record 3 must neither
            # abort records 4..N unattempted nor mislabel them
            # never_snapshotted — every session's fate gets recorded
            for fsid, rec in targets:
                # the watchdog may have settled this sid to a terminal
                # 410 while it waited its turn (behind a stalled
                # predecessor record): the client was TOLD it is lost
                # and the documented recourse is a fresh resubmission —
                # resuming it now would run the trajectory twice.  The
                # terminal answer is sticky; honor it.
                with self._lock:
                    settled = fsid in self._failed
                if settled:
                    log.warning(
                        "fleet: %s settled by the stuck watchdog before "
                        "its resume could run; not resuming", fsid,
                    )
                    continue
                try:
                    self._migrate_one(fsid, rec)
                except Exception:
                    log.exception("fleet: resume of %s crashed", fsid)
                    self._record_failure(fsid, "migration_failed")
                if isinstance(rec, MeshSpillRecord) and rec.root.exists():
                    with self._lock:
                        lost = fsid in self._failed
                    if not lost:
                        # the survivor admitted the resume but could NOT
                        # adopt the tiles by rename (no local spill store
                        # of its own): it will re-gather from THIS
                        # directory at admission, so the victim dir must
                        # outlive the run — a bounded disk leak, never a
                        # truncated re-gather
                        log.warning(
                            "fleet: %s resumed without tile adoption; "
                            "keeping victim spill dir %s", fsid, d,
                        )
                        cleanup = False
                # progress heartbeat: a LIVE run refreshes its watchdog
                # clock after every record it settles, so stuck_after_s
                # bounds one record's stall — never the wall time of a
                # many-session rescue
                with self._lock:
                    if (name, generation) in self._active:
                        self._active[(name, generation)] = self.clock()
        finally:
            with self._lock:
                self._active.pop((name, generation), None)
                self._completed.add((name, generation))
            if cleanup:
                # the victim's spills are orphaned now: every session
                # either lives on a survivor (which spills it under its
                # OWN namespace) or is terminally lost — either way these
                # bytes must not be resumed a second time
                if remote_ns is not None:
                    from tpu_life_torch.serve.spill_http import delete_remote_namespace

                    delete_remote_namespace(self.spill_url, remote_ns)
                else:
                    shutil.rmtree(d, ignore_errors=True)

    def _target_fsid(self, name: str, generation: int, sid: str) -> str:
        with self._lock:
            return self._alias.pop((name, generation, sid), None) or fleet_sid(
                name, generation, sid
            )

    def _migrate_one(self, fsid: str, rec) -> None:
        is_mesh = isinstance(rec, MeshSpillRecord)
        body = json.dumps(
            mesh_resume_request(rec) if is_mesh else resume_request(rec)
        ).encode()
        deadline = self.clock() + self.timeout_s
        attempt = 0
        while True:
            ready = self.supervisor.ready_workers()
            outcome, hint = self._try_candidates(
                fsid, body, ready, rec.trace_id
            )
            if outcome == "refused" and self.peers and not is_mesh:
                # every LOCAL survivor definitively declined (or none is
                # ready): re-home across the host boundary — the peer
                # control plane's router speaks the same protocol, and the
                # original sid keeps answering through the peer proxy
                outcome, peer_hint = self._try_peers(fsid, body, rec.trace_id)
                hint = max(hint, peer_hint)
            if outcome in ("migrated", "peer", "failed"):
                break
            # everyone refused: capacity pressure, not a verdict — pace
            # on the shared jittered-exponential curve (an explicit
            # Retry-After hint wins, un-jittered: the refuser TOLD us
            # when) and retry until the budget runs out.  Jitter matters
            # here specifically: a mass rescue runs one of these loops
            # per session, and a briefly-overloaded survivor must not be
            # re-hammered by all of them in lockstep.
            if self.clock() >= deadline:
                self._record_failure(fsid, "migration_failed")
                return
            attempt += 1
            self.sleep(
                max(
                    hint,
                    backoff_delay(
                        attempt,
                        base=self.retry_pause_s,
                        cap=self.max_retry_pause_s,
                    ),
                )
            )
        if outcome == "failed":
            self._record_failure(fsid, "migration_failed")
        else:
            with self._lock:
                self._progress.pop(fsid, None)
                self._pending_since.pop(fsid, None)
            self._c_migrations.labels(
                outcome="peer" if outcome == "peer" else "migrated"
            ).inc()

    def _try_candidates(
        self, fsid: str, body: bytes, ready, trace_id: str | None = None
    ) -> tuple[str, float]:
        """One pass over the ready workers: ``('migrated' | 'failed' |
        'refused', retry_after_hint)`` — 'failed' is ambiguous or a
        protocol rejection (do not retry); 'refused' means every candidate
        definitively declined (safe to retry), with the largest
        ``Retry-After`` any refuser volunteered as the pacing hint."""
        hint = 0.0
        for worker in self.balancer.candidates(ready):
            # capture BEFORE the round-trip (the route_submit rule): a
            # crash+respawn mid-forward must not alias the wrong life
            target_gen = worker.generation
            try:
                status, retry_after, doc = self.forward(
                    worker, "POST", ROUTE_SESSIONS, body=body
                )
            except WorkerUnreachable as e:
                if e.refused or not worker.alive:
                    self.balancer.invalidate(worker)
                    continue
                # mid-exchange on a live worker: the resume may exist
                # there — re-submitting could duplicate the trajectory
                log.warning(
                    "fleet: resume of %s on %s ambiguous (%s); not retried",
                    fsid,
                    worker.name,
                    e.cause,
                )
                return "failed", 0.0
            if retry_after:
                hint = max(hint, retry_after)
            if status == 201:
                wsid = doc.get("session")
                if not isinstance(wsid, str):
                    return "failed", 0.0
                self.sessions.repin(fsid, worker.name, target_gen, wsid)
                with self._lock:
                    self._alias[(worker.name, target_gen, wsid)] = fsid
                    while len(self._alias) > MAX_OUTCOMES:
                        self._alias.popitem(last=False)
                self.balancer.invalidate(worker)
                log.info(
                    "fleet: %s resumed on %s gen %d as %s",
                    fsid,
                    worker.name,
                    target_gen,
                    wsid,
                )
                obs.flight.record(
                    "migrate.resumed",
                    sid=fsid,
                    trace_id=trace_id,
                    worker=worker.name,
                    generation=target_gen,
                    worker_sid=wsid,
                )
                return "migrated", 0.0
            code = _error_code(doc)
            if status == 503 and code in REFUSAL_CODES:
                self.balancer.invalidate(worker)
                continue
            if status == 429:
                # rate-limited: the token bucket rejects BEFORE anything
                # is stored, so the session definitively was not created —
                # retryable capacity pressure, never a terminal verdict
                # (resumes share the workers' anonymous bucket)
                self.balancer.invalidate(worker)
                continue
            # a protocol rejection (400 family) of a spill-derived resume
            # is deterministic: failing N more times adds nothing
            log.error(
                "fleet: resume of %s rejected by %s: %s %s", fsid,
                worker.name, status, code,
            )
            return "failed", 0.0
        return "refused", hint

    def _try_peers(
        self, fsid: str, body: bytes, trace_id: str | None = None
    ) -> tuple[str, float]:
        """One pass over the peer control planes: ``('peer' | 'failed' |
        'refused', hint)``.  The same no-ambiguous-retry discipline as the
        worker pass — a mid-exchange failure against a peer router may
        have created the session over there, and re-submitting anywhere
        would run the trajectory twice."""
        import socket
        import urllib.error
        import urllib.request

        hint = 0.0
        for peer in self.peers:
            if chaos.partitioned("migrate", peer):
                log.warning(
                    "fleet: peer %s unreachable for %s (partition)", peer, fsid
                )
                continue
            req = urllib.request.Request(
                peer.rstrip("/") + ROUTE_SESSIONS, data=body, method="POST"
            )
            req.add_header("Content-Type", "application/json")
            if trace_id is not None:
                # trace continuity across the HOST boundary: the peer's
                # ROUTER honors X-Trace-Id — without it, the peer would
                # mint a fresh id (the header wins over the body field at
                # the worker), severing the journey exactly on the
                # cross-host rescue the trace exists to show
                req.add_header("X-Trace-Id", trace_id)
            try:
                try:
                    with urllib.request.urlopen(
                        req, timeout=self.timeout_s
                    ) as resp:
                        status, retry_after, doc = resp.status, None, _json(resp)
                except urllib.error.HTTPError as e:
                    from tpu_life_torch.gateway.errors import parse_retry_after

                    status, retry_after, doc = (
                        e.code, parse_retry_after(e.headers), _json(e)
                    )
            except (urllib.error.URLError, ConnectionError, socket.timeout, TimeoutError) as e:
                reason = getattr(e, "reason", e)
                refused = isinstance(reason, ConnectionRefusedError) or isinstance(
                    e, ConnectionRefusedError
                )
                if refused:
                    continue  # the peer never saw it: safe to try the next
                log.warning(
                    "fleet: resume of %s on peer %s ambiguous (%s); not retried",
                    fsid,
                    peer,
                    e,
                )
                return "failed", 0.0
            if retry_after:
                hint = max(hint, retry_after)
            if status == 201:
                peer_sid = doc.get("session")
                if not isinstance(peer_sid, str):
                    return "failed", 0.0
                with self._lock:
                    self._peer_pins[fsid] = (peer.rstrip("/"), peer_sid)
                    while len(self._peer_pins) > MAX_OUTCOMES:
                        self._peer_pins.popitem(last=False)
                log.info(
                    "fleet: %s resumed on PEER %s as %s (cross-host rescue)",
                    fsid,
                    peer,
                    peer_sid,
                )
                obs.flight.record(
                    "migrate.peer",
                    sid=fsid,
                    trace_id=trace_id,
                    peer=peer,
                    peer_sid=peer_sid,
                )
                return "peer", 0.0
            code = _error_code(doc)
            if status in (429, 503) and (
                status == 429 or code in PEER_REFUSAL_CODES
            ):
                continue  # definitively not admitted over there: next peer
            log.error(
                "fleet: resume of %s rejected by peer %s: %s %s",
                fsid,
                peer,
                status,
                code,
            )
            return "failed", 0.0
        return "refused", hint

    def _record_failure(
        self, fsid: str, reason: str, *, counter: str = "failed"
    ) -> None:
        obs.flight.record("migrate.failed", sid=fsid, reason=reason)
        with self._lock:
            self._failed[fsid] = reason
            while len(self._failed) > MAX_OUTCOMES:
                self._failed.popitem(last=False)
            self._progress.pop(fsid, None)
            self._pending_since.pop(fsid, None)
        self._c_migrations.labels(outcome=counter).inc()
        log.warning("fleet: session %s not recovered (%s)", fsid, reason)

