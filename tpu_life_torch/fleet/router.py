"""The fleet router: one HTTP front speaking the gateway protocol for N
workers.

Clients talk to the router exactly as they would to a single gateway —
the unmodified ``GatewayClient`` works against it — and the router
forwards:

- ``POST /v1/sessions``: pick a worker (weighted least queue depth —
  depth normalized by the worker's resolved device count — from a
  TTL-cached ``/metrics`` scrape, ties spread by smooth weighted
  round-robin), forward the body verbatim, pin the
  returned sid in the session registry, and answer with the namespaced
  fleet sid (``w1g2-s000042`` — worker, generation, worker's own sid).  A worker that *refuses* — connection
  refused (the request was never seen) or a typed 503 (shedding /
  queue-full / draining: the session was definitively not created) — is
  retried on the next candidate.  A worker that fails *mid-exchange*
  (timeout, reset) is NOT retried: the session may exist, and
  re-forwarding would silently duplicate it (the client's own
  no-duplicate-session rule, applied server-side).  503
  ``fleet_unavailable`` only when every candidate refused.
- ``GET/DELETE /v1/sessions/{fleet-sid}[...]``: resolve the pin and hit
  the exact worker generation that owns the session; a pin into a dead
  worker or a stale generation is a typed 410 ``worker_lost``.

Fleet endpoints aggregate the tier: ``/healthz`` (router liveness +
worker states), ``/readyz`` (503 unless ≥1 worker is ready), and
``/metrics`` (the fleet's own families plus every live worker's registry,
merged with a ``worker`` label so per-worker series never collide).
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from urllib.parse import urlsplit

from tpu_life_torch import chaos, obs
from tpu_life_torch.fleet import errors as fl_errors
from tpu_life_torch.fleet.balancer import LeastDepthBalancer, prom_value
from tpu_life_torch.fleet.fanout import FanoutHub
from tpu_life_torch.fleet.membership import ROUTE_HEARTBEAT, ROUTE_REGISTER
from tpu_life_torch.fleet.registry import SessionRegistry
from tpu_life_torch.fleet.supervisor import (
    FleetConfig,
    Supervisor,
    Worker,
    WorkerState,
    worker_weight,
)
from tpu_life_torch.gateway import errors as gw_errors
from tpu_life_torch.gateway.errors import ApiError, parse_retry_after
from tpu_life_torch.gateway.server import ROUTE_SESSIONS, JsonHandler
from tpu_life_torch.runtime.metrics import log
from tpu_life_torch.version import __version__

#: Worker 503 codes that mean "definitively not admitted" — safe to retry
#: the submission on the next candidate without risking a duplicate.
REFUSAL_CODES = frozenset(
    {"overloaded", "queue_full", "draining", "shed_best_effort"}
)

#: Socket read timeout on an upstream worker stream: frames arrive every
#: scheduling round while a session runs, so a read that blocks this
#: long means the link (or the worker) is gone — the fan-out puller
#: reconnects with its cursor and the survivor re-keys.
STREAM_READ_TIMEOUT_S = 30.0

#: How long a fan-out upstream open waits on a 409 ``migrating`` answer
#: before treating the sid as lost — failover replay is seconds, not
#: minutes.
STREAM_MIGRATE_WAIT_S = 30.0


class WorkerUnreachable(Exception):
    """Transport-level forward failure; ``refused`` means the connection
    was refused outright (the worker never saw the request)."""

    def __init__(self, worker: Worker, refused: bool, cause: Exception):
        super().__init__(f"{worker.name}: {cause}")
        self.worker = worker
        self.refused = refused
        self.cause = cause


class Router:
    """Owns the HTTP listener, the balancer, and the session pins."""

    def __init__(
        self,
        config: FleetConfig,
        supervisor: Supervisor,
        sessions: SessionRegistry,
        registry,
    ):
        self.config = config
        self.supervisor = supervisor
        self.sessions = sessions
        # weighted least-depth (docs/FLEET.md "Device placement"): depth
        # is normalized by the worker's resolved device count, so a
        # 4-chip worker absorbs ~4x the sessions of a 1-chip peer
        self.balancer = LeastDepthBalancer(
            self._fetch_depth, ttl_s=config.depth_ttl_s, weight=worker_weight
        )
        self._c_routed = registry.counter(
            "fleet_routed_total", "sessions routed, by worker", labels=("worker",)
        )
        self._c_retry = registry.counter(
            "fleet_retry_total",
            "submissions retried on another worker after a refusal",
        )
        self._c_retry.labels()
        self.registry = registry
        # the durability seam (docs/FLEET.md): set by the fleet when a
        # spill dir is configured.  With a migrator, a dead worker's
        # pinned sids answer 409 ``migrating`` (or a synthetic running
        # view on plain polls) until the migration run settles them;
        # without one, worker death stays terminal (410, reason
        # ``spill_disabled``).
        self.migrator = None
        # the watcher fan-out tier (docs/STREAMING.md): N watchers of one
        # sid share ONE upstream worker stream; the shed counter and the
        # live-watcher gauge land in the fleet registry
        self.fanout = FanoutHub(open_upstream=self._open_upstream, registry=registry)
        self._server = _RouterHTTPServer((config.host, config.port), _Handler)
        self._server.router = self
        self.host, self.port = self._server.server_address[:2]
        self._serve_thread: threading.Thread | None = None
        self._draining = False
        self._closed = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="fleet-router",
            daemon=True,
        )
        self._serve_thread.start()
        log.info("fleet: router listening on http://%s:%d", self.host, self.port)

    def begin_drain(self) -> None:
        """Stop admitting (``/readyz`` -> 503, submits -> 503 draining);
        poll/result/cancel keep forwarding while workers finish."""
        self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.fanout.close()
        if self._serve_thread is not None:
            self._server.shutdown()
        self._server.server_close()

    # -- worker I/O --------------------------------------------------------
    def _fetch_depth(self, worker: Worker) -> float:
        text = self._fetch_text(worker, "/metrics", timeout=2.0)
        v = prom_value(text, "serve_queue_depth")
        if v is None:
            raise ValueError(f"{worker.name}: no serve_queue_depth sample")
        return v

    def _fetch_text(self, worker: Worker, path: str, timeout: float) -> str:
        req = urllib.request.Request(worker.url + path)
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read().decode()

    def forward(
        self,
        worker: Worker,
        method: str,
        path: str,
        *,
        body: bytes | None = None,
        api_key: str | None = None,
        trace_id: str | None = None,
    ) -> tuple[int, float | None, dict]:
        """One proxied request; returns (status, retry_after, json body).
        HTTP error statuses return normally (they are protocol answers to
        relay); transport failures raise :class:`WorkerUnreachable`."""
        if worker.url is None:
            raise WorkerUnreachable(
                worker, True, ConnectionRefusedError("worker has no bound URL")
            )
        # chaos seam (docs/CHAOS.md): a socket reset BEFORE the request is
        # written.  The worker never saw it, so the honest classification
        # is a refusal — submits retry the next candidate (no duplicate is
        # possible), exactly the path a NIC hiccup at connect exercises.
        if method == "POST" and chaos.decide("router.submit.reset") is not None:
            chaos.record_fire("router.submit.reset", "reset")
            raise WorkerUnreachable(
                worker, True, ConnectionResetError("chaos: pre-send reset")
            )
        # chaos seam: the seeded per-peer connectivity mask severs THIS
        # router->worker link (docs/CHAOS.md ``net.partition``).  The
        # honest transport shape is a connect that never establishes —
        # a refusal, so submits retry the next candidate and pinned
        # requests consult the migrator exactly as a real partition would.
        # The site prefix keeps the pair label unique when two control
        # planes share one process (the cross-host drill): without it,
        # plane A's and plane B's links to same-named workers would share
        # one draw counter and the per-link schedule would depend on
        # thread interleaving instead of the seed alone.
        if chaos.partitioned(f"{self.config.site}router", worker.name):
            raise WorkerUnreachable(
                worker, True, ConnectionRefusedError("chaos: net partition")
            )
        poll_fault = (
            chaos.decide("router.poll.reset")
            if method in ("GET", "DELETE")
            else None
        )
        req = urllib.request.Request(worker.url + path, data=body, method=method)
        if body is not None:
            req.add_header("Content-Type", "application/json")
        if api_key is not None:
            req.add_header("X-API-Key", api_key)
        if trace_id is not None:
            # cross-process trace propagation (docs/OBSERVABILITY.md):
            # the worker stamps this id onto the session it creates
            req.add_header("X-Trace-Id", trace_id)
        try:
            try:
                with urllib.request.urlopen(
                    req, timeout=self.config.forward_timeout_s
                ) as resp:
                    status, retry_after, doc = resp.status, None, _json_body(resp)
            except urllib.error.HTTPError as e:
                # an error STATUS is still a completed exchange — the
                # injected resets below apply to it exactly as to a 200
                # (a 409/410 answer can be lost on the wire too)
                status, retry_after, doc = (
                    e.code, parse_retry_after(e.headers), _json_body(e)
                )
            if poll_fault is not None:
                chaos.record_fire("router.poll.reset", poll_fault.fault.mode)
                if poll_fault.fault.mode == "mid_exchange":
                    # the exchange completed but the answer is lost on the
                    # wire: ambiguous — the handlers must treat it as a
                    # maybe-processed failure, never silently retry a POST
                    raise WorkerUnreachable(
                        worker,
                        False,
                        ConnectionResetError("chaos: mid-exchange reset"),
                    )
                # mid_body: the response truncated — the body parses empty
                doc = {}
            return status, retry_after, doc
        except (urllib.error.URLError, ConnectionError, socket.timeout, TimeoutError) as e:
            reason = getattr(e, "reason", e)
            refused = isinstance(reason, ConnectionRefusedError) or isinstance(
                e, ConnectionRefusedError
            )
            raise WorkerUnreachable(worker, refused, e) from None

    # -- routing -----------------------------------------------------------
    def route_submit(
        self, body: bytes, api_key: str | None, trace_id: str | None = None
    ) -> tuple[int, float | None, dict]:
        """The submit pipeline: candidates by least depth, refusal-only
        retry, pin on 201.  Returns (status, retry_after, response doc).

        ``trace_id`` is the distributed-trace context this router MINTS
        per submitted session (honoring a client-supplied ``X-Trace-Id``
        — the handler validates and passes it): forwarded to the chosen
        worker on the wire, recorded with the pin's flight event, and
        carried by the session through every later hop (spill, kill,
        migration) so the whole journey joins on one id."""
        if self._draining:
            raise ApiError(
                503,
                "draining",
                "the fleet is draining: no new sessions are admitted",
                retry_after=1.0,
            )
        ready = self.supervisor.ready_workers()
        if not ready:
            raise fl_errors.no_ready_workers(len(self.supervisor.workers))
        hint = 1.0
        mesh_retried = False
        shed_relay = None  # last typed best-effort shed seen on the walk
        for i, worker in enumerate(self.balancer.candidates(ready)):
            if i > 0:
                self._c_retry.inc()
            # capture the generation BEFORE the round-trip: if the worker
            # crashes and respawns mid-forward, pinning the (dead) session
            # under the successor's generation would hand its sid numbers
            # to the wrong tenant — the exact confusion the generation
            # namespace exists to prevent
            generation = worker.generation
            try:
                status, retry_after, doc = self.forward(
                    worker,
                    "POST",
                    ROUTE_SESSIONS,
                    body=body,
                    api_key=api_key,
                    trace_id=trace_id,
                )
            except WorkerUnreachable as e:
                if e.refused or not worker.alive:
                    # refused = the worker never saw the request; dead = even
                    # if it did, the session died with the process and can
                    # never be observed — either way the next candidate
                    # cannot produce a duplicate.  Only a mid-exchange
                    # failure on a LIVE worker is ambiguous (502 below).
                    log.warning(
                        "fleet: %s unreachable on submit; trying next", worker.name
                    )
                    self.balancer.invalidate(worker)
                    continue
                raise fl_errors.upstream_error(worker.name, str(e.cause)) from None
            if status == 201:
                return 201, None, self._finish_submit(
                    worker, generation, doc, trace_id
                )
            if status == 503 and _error_code(doc) in REFUSAL_CODES:
                # a definitive refusal — the session was not created
                log.info(
                    "fleet: %s refused submit (%s); trying next",
                    worker.name,
                    _error_code(doc),
                )
                self.balancer.invalidate(worker)
                if retry_after:
                    hint = max(hint, retry_after)
                if _error_code(doc) == "shed_best_effort":
                    doc.setdefault("worker", worker.name)
                    shed_relay = doc
                continue
            # a mesh-eligible 413 (docs/SERVING.md "Mega-board sessions")
            # is the one protocol rejection the router does NOT relay
            # blindly: the refuser volunteered the minimum slice size, so
            # one targeted retry against the largest ready worker whose
            # reserved slice clears it is acting on the hint, not the
            # N-fold deterministic-400 replay the verbatim rule forbids
            if status == 413 and not mesh_retried:
                target = self._mesh_candidate(doc, ready, worker)
                if target is not None:
                    mesh_retried = True
                    out = self._mesh_retry(
                        target, body, api_key, trace_id, worker, doc
                    )
                    if out is not None:
                        return out
            # any other answer (400/413/429/...) is the worker speaking the
            # protocol: relay it verbatim — retrying a deterministic 400 on
            # another worker would just fail N times instead of once
            doc.setdefault("worker", worker.name)
            return status, retry_after, doc
        if shed_relay is not None:
            # the QoS shed ladder stays TYPED end to end (docs/SERVING.md
            # "Tenant QoS"): a best-effort submit shed by every candidate
            # relays a worker's own ``shed_best_effort`` envelope — a
            # generic ``fleet_unavailable`` would erase the tier the
            # client's documented recourse (sleep Retry-After, resubmit)
            # keys on, and only best-effort tenants can draw this code
            return 503, hint, shed_relay
        raise fl_errors.fleet_unavailable(len(ready), retry_after=hint)

    def _finish_submit(
        self, worker: Worker, generation: int, doc: dict, trace_id: str | None
    ) -> dict:
        """The 201 bookkeeping shared by the depth-ranked path and the
        mesh retry: pin the sid under the generation captured BEFORE the
        round-trip, stamp the trace, and invalidate the now-staler depth
        reading."""
        sid = doc.get("session")
        if isinstance(sid, str):
            doc["session"] = self.sessions.pin(worker.name, generation, sid)
            # the journey's first control-plane event: which
            # fleet sid this trace was routed as, and to whom —
            # the join key `tpu-life doctor --sid` resolves with
            obs.flight.record(
                "route.submit",
                sid=doc["session"],
                worker_sid=sid,
                trace_id=trace_id,
                worker=worker.name,
                generation=generation,
            )
        if trace_id is not None:
            doc.setdefault("trace_id", trace_id)
        doc["worker"] = worker.name
        self._c_routed.labels(worker=worker.name).inc()
        # this worker's queue just grew: re-scrape before routing
        # the next submit rather than trusting the stale reading
        self.balancer.invalidate(worker)
        return doc

    def _mesh_candidate(
        self, doc: dict, ready: list, rejected_by: Worker
    ) -> Worker | None:
        """The worker a mesh-eligible 413 should be retried on: the
        LARGEST ready slice (most resolved devices) that clears the
        refuser's ``min_devices`` hint — biggest first, because a board
        at the edge of one worker's budget fits with the most headroom on
        the widest mesh.  None when the 413 carries no mesh hint or no
        ready worker's slice is big enough."""
        err = doc.get("error")
        if not isinstance(err, dict) or not err.get("mesh_eligible"):
            return None
        need = err.get("min_devices")
        need = int(need) if isinstance(need, (int, float)) else 2
        best = None
        for w in ready:
            if w is rejected_by:
                continue
            dev = getattr(w, "devices", None) or 1
            if dev >= need and (
                best is None or dev > (getattr(best, "devices", None) or 1)
            ):
                best = w
        return best

    def _mesh_retry(
        self,
        target: Worker,
        body: bytes,
        api_key: str | None,
        trace_id: str | None,
        rejected_by: Worker,
        reject_doc: dict,
    ) -> tuple[int, float | None, dict] | None:
        """One targeted re-forward of a mesh-eligible 413 to ``target``.
        Returns the answer to send the client, or None to fall through to
        relaying the original 413 (the target never saw the request, so
        no duplicate is possible)."""
        err = reject_doc.get("error") or {}
        obs.flight.record(
            "route.mesh_retry",
            trace_id=trace_id,
            rejected_by=rejected_by.name,
            worker=target.name,
            devices=getattr(target, "devices", None),
            min_devices=err.get("min_devices"),
        )
        generation = target.generation
        try:
            status, retry_after, doc = self.forward(
                target,
                "POST",
                ROUTE_SESSIONS,
                body=body,
                api_key=api_key,
                trace_id=trace_id,
            )
        except WorkerUnreachable as e:
            if e.refused or not target.alive:
                # the slice never saw it (or died with it): the honest
                # answer is the original 413 — fall through to the relay
                self.balancer.invalidate(target)
                return None
            raise fl_errors.upstream_error(target.name, str(e.cause)) from None
        if status == 201:
            self._c_retry.inc()
            return 201, None, self._finish_submit(
                target, generation, doc, trace_id
            )
        # the big slice ALSO said no: ITS answer (a 413 with its own
        # numbers, or a refusal) supersedes the first worker's
        doc.setdefault("worker", target.name)
        return status, retry_after, doc

    def resolve(self, fsid: str) -> tuple[Worker, str]:
        """Fleet sid -> (live worker of the pinned generation, worker sid);
        typed 404 / 409 migrating / 410+reason otherwise.

        A migrated sid's pin was re-pointed at its survivor, so it
        resolves like any live pin.  A pin whose home is gone consults
        the migrator: still being rescued -> 409 ``migrating`` (retry
        later, same sid); settled without a rescue -> 410 with a
        ``reason`` (never_snapshotted / spill_corrupt /
        migration_failed); no migrator at all -> 410, reason
        ``spill_disabled`` (the pre-durability contract: the successor
        mints the same sid NUMBERS for new tenants — the generation in
        the pin is what keeps them apart)."""
        pin = self.sessions.resolve(fsid)
        if pin is None:
            raise fl_errors.unknown_session(fsid)
        worker = self.supervisor.get(pin.worker)
        if worker is None:
            raise fl_errors.unknown_session(fsid)
        if (
            worker.generation == pin.generation
            and worker.alive
            and worker.state not in (WorkerState.DOWN, WorkerState.FAILED)
        ):
            return worker, pin.sid
        # the pinned incarnation is gone (dead, reaped, or replaced)
        raise self._gone_error(fsid, pin)

    def _gone_error(self, fsid: str, pin) -> ApiError:
        """The typed answer for a sid whose pinned worker incarnation is
        gone: 409 ``migrating`` while (or until) the migrator rescues it,
        410 + reason once its fate is settled (or durability is off)."""
        if self.migrator is not None:
            # the "rescue imminent" fallback only applies when the pin
            # targets the worker's CURRENT generation (a death the
            # monitor tick hasn't processed yet) — a pin into an unknown
            # past generation has no migration coming and must settle
            w = self.supervisor.get(pin.worker)
            pending_ok = w is not None and w.generation == pin.generation
            st = self.migrator.status(fsid, pin, pending_ok=pending_ok)
            if st[0] == "migrating":
                return fl_errors.migrating(fsid)
            return fl_errors.worker_lost(pin.worker, fsid, reason=st[1])
        return fl_errors.worker_lost(pin.worker, fsid)

    def _open_upstream(self, fsid: str, cursor: int):
        """One upstream worker stream for the fan-out tier (runs on a
        fan's puller thread): resolve the pin FRESH — after a failover it
        names the survivor — waiting bounded through a 409 ``migrating``
        window, then consume the worker's ndjson frames starting at
        ``cursor``.  Transport failures (and torn frames) raise; the
        :class:`FanoutHub` reconnects with the next cursor it needs."""
        deadline = time.monotonic() + STREAM_MIGRATE_WAIT_S
        while True:
            try:
                worker, sid = self.resolve(fsid)
                break
            except ApiError as e:
                if e.code == "migrating" and time.monotonic() < deadline:
                    time.sleep(0.1)
                    continue
                raise
        if chaos.partitioned(f"{self.config.site}router", worker.name):
            raise ConnectionRefusedError("chaos: net partition")
        url = f"{worker.url}{ROUTE_SESSIONS}/{sid}/stream?cursor={int(cursor)}"
        req = urllib.request.Request(url)
        with urllib.request.urlopen(req, timeout=STREAM_READ_TIMEOUT_S) as resp:
            for line in resp:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    # a torn frame: the worker died mid-write — the
                    # reconnect-with-cursor contract, not a parse bug
                    raise ConnectionError(
                        f"{fsid}: torn frame on upstream stream"
                    ) from None

    def route_pinned(
        self,
        method: str,
        fsid: str,
        tail: str,
        api_key: str | None,
        body: bytes | None = None,
    ) -> tuple[int, float | None, dict]:
        # a session rescued onto a PEER control plane (docs/FLEET.md
        # "Cross-host topology") answers under its original sid: the pin
        # still names the dead local home, so the peer map is consulted
        # first and the request proxies to the peer router, which speaks
        # the exact same protocol
        peer = self.migrator.peer_of(fsid) if self.migrator is not None else None
        if peer is not None:
            return self._route_peer(method, fsid, peer, tail, api_key, body=body)
        worker, sid = self.resolve(fsid)
        try:
            status, retry_after, doc = self.forward(
                worker,
                method,
                f"{ROUTE_SESSIONS}/{sid}{tail}",
                api_key=api_key,
                body=body,
            )
        except WorkerUnreachable as e:
            dead = e.refused or not worker.alive
            if not dead and method in ("GET", "DELETE"):
                # a SIGKILL closes the worker's sockets a beat before the
                # process becomes waitable: a poll reset in that window
                # would misread as a 502.  GET/DELETE are idempotent, so
                # re-checking liveness after a grace beat is safe (POST
                # never reaches this path — pinned routes are GET/DELETE).
                time.sleep(0.05)
                dead = not worker.alive
            if dead:
                # no listener on the pinned port, or the process itself is
                # dead (a freshly SIGKILLed worker answers with a reset
                # before the supervisor reaps it): the session's state died
                # with the process — typed, not a 502.  A restart binds a
                # fresh ephemeral port, so this can never reach the
                # successor generation by accident.  Re-resolve the pin for
                # the migrator consult: with durability on, this freshly
                # observed death answers 409 migrating, not 410.
                pin = self.sessions.resolve(fsid)
                if pin is not None:
                    raise self._gone_error(fsid, pin) from None
                raise fl_errors.worker_lost(worker.name, fsid) from None
            raise fl_errors.upstream_error(worker.name, str(e.cause)) from None
        if isinstance(doc.get("session"), str):
            doc["session"] = fsid
        doc["worker"] = worker.name
        return status, retry_after, doc

    def _route_peer(
        self,
        method: str,
        fsid: str,
        peer: tuple[str, str],
        tail: str,
        api_key: str | None,
        body: bytes | None = None,
    ) -> tuple[int, float | None, dict]:
        """Proxy one pinned request to the peer control plane that adopted
        the session; the client keeps its original fleet sid."""
        peer_url, peer_sid = peer
        if chaos.partitioned(f"{self.config.site}router", peer_url):
            raise fl_errors.peer_unreachable(
                peer_url, "net partition to peer control plane"
            )
        req = urllib.request.Request(
            f"{peer_url}{ROUTE_SESSIONS}/{peer_sid}{tail}", data=body, method=method
        )
        if body is not None:
            req.add_header("Content-Type", "application/json")
        if api_key is not None:
            req.add_header("X-API-Key", api_key)
        try:
            try:
                with urllib.request.urlopen(
                    req, timeout=self.config.forward_timeout_s
                ) as resp:
                    status, retry_after, doc = resp.status, None, _json_body(resp)
            except urllib.error.HTTPError as e:
                status, retry_after, doc = (
                    e.code, parse_retry_after(e.headers), _json_body(e)
                )
        except (urllib.error.URLError, ConnectionError, socket.timeout, TimeoutError) as e:
            # the peer plane is unreachable, never a 410 — the session may
            # be running fine over there.  Proxied requests are all
            # idempotent GET/DELETE, so unlike the mid-exchange 502 this
            # is a retryable 503: a poll loop rides through a link blip.
            raise fl_errors.peer_unreachable(peer_url, str(e)) from None
        if isinstance(doc.get("session"), str):
            doc["session"] = fsid
        doc["peer"] = peer_url
        return status, retry_after, doc

    def migrating_view(self, fsid: str) -> dict:
        """A synthetic in-progress poll body for a sid mid-migration, so
        an unmodified poll-until-done client (``GatewayClient.wait``)
        rides straight through a worker kill: ``finished`` stays false,
        progress is the last spilled position when the manifest has been
        read, and the next poll after the re-pin lands on the survivor.
        Only plain GET polls get this — result/cancel answer the typed
        409 ``migrating`` (+ Retry-After) instead, because "here is a
        board" and "it is cancelled" cannot be synthesized truthfully.
        Progress comes from the spill manifest (published for every
        record before any resume runs); in the short window before the
        manifests are read, the progress keys are OMITTED rather than
        reported as a regressed 0/0 — steps_done must only ever grow."""
        view = {
            "session": fsid,
            "state": "running",
            "migrating": True,
            "finished": False,
            "error": None,
            "fleet": True,
        }
        progress = self.migrator.progress(fsid) if self.migrator else None
        if progress is not None:
            total, done = progress
            view["steps"] = total
            view["steps_done"] = done
            view["progress"] = done / total if total else 0.0
        return view

    # -- fleet endpoints ---------------------------------------------------
    def merged_metrics(self) -> str:
        """The fleet registry plus every reachable worker's registry, each
        worker's samples tagged ``worker="<name>"``.  Workers are scraped
        CONCURRENTLY: the endpoint's latency is the slowest single scrape,
        so one wedged worker burning its timeout cannot push the whole
        fleet's exposition past a scraper's deadline."""
        workers = [
            w for w in self.supervisor.workers if w.url is not None and w.alive
        ]
        texts: list[str | None] = [None] * len(workers)

        def scrape(i: int, w: Worker) -> None:
            try:
                texts[i] = self._fetch_text(w, "/metrics", timeout=2.0)
            except Exception:
                log.debug("fleet: metrics scrape of %s failed", w.name)

        threads = [
            threading.Thread(target=scrape, args=(i, w), daemon=True)
            for i, w in enumerate(workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        sources: list[tuple[str | None, str]] = [
            (None, self.registry.prom_text())
        ]
        sources += [
            (w.name, text) for w, text in zip(workers, texts) if text is not None
        ]
        return merge_prom_texts(sources)


class _RouterHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    router: Router  # attached right after construction


class _Handler(JsonHandler):
    server_version = f"tpu-life-fleet/{__version__}"
    log_tag = "fleet"

    @property
    def rt(self) -> Router:
        return self.server.router  # type: ignore[attr-defined]

    def _read_body(self) -> bytes:
        """The raw request body, bounded — the router forwards it verbatim
        (workers own the JSON validation), but the byte bound is admission
        control and belongs at the front."""
        return self._read_sized_body(self.rt.config.max_body)

    def _read_json(self) -> dict:
        """A bounded JSON object body for the fleet's OWN endpoints
        (registration / heartbeat) — typed 400 on garbage."""
        try:
            doc = json.loads(self._read_body() or b"{}")
        except json.JSONDecodeError as e:
            raise fl_errors.bad_registration(f"body is not JSON: {e}") from None
        if not isinstance(doc, dict):
            raise fl_errors.bad_registration("body must be a JSON object")
        return doc

    # -- dispatch ----------------------------------------------------------
    def do_GET(self):  # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self):  # noqa: N802
        self._dispatch("DELETE")

    def do_PATCH(self):  # noqa: N802
        self._dispatch("PATCH")

    def _dispatch(self, method: str) -> None:
        parts = urlsplit(self.path)
        path = parts.path.rstrip("/") or "/"
        try:
            self._route(method, path, parts.query)
        except ApiError as e:
            try:
                body = e.body()
                body["fleet"] = True  # who answered: the router, not a worker
                self._send_json(e.status, body, retry_after=e.retry_after)
            except (BrokenPipeError, ConnectionResetError):
                pass
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception:
            log.exception("fleet: %s %s failed", method, path)
            try:
                self._send_json(
                    500,
                    {"error": {"code": "internal", "message": "internal error"}},
                )
            except (BrokenPipeError, ConnectionResetError):
                pass

    def _route(self, method: str, path: str, query: str) -> None:
        rt = self.rt
        api_key = self.headers.get("X-API-Key")
        if path == "/healthz":
            self._require(method, "GET", path)
            capacity = rt.supervisor.capacities()
            self._send_json(
                200,
                {
                    "status": "ok",
                    "workers": rt.supervisor.states(),
                    # per-worker resolved devices + routing weight, and
                    # the fleet's aggregate device count — the capacity-
                    # planning numbers (docs/FLEET.md "Device placement";
                    # per-worker counts SUM only when placement makes the
                    # slices disjoint — shared-env workers co-claim one
                    # device set and report its size, once)
                    "capacity": capacity,
                    "devices_total": rt.supervisor.devices_total(),
                    # workers refusing their probe with a TYPED reason
                    # (e.g. the serve wedge watchdog's engine_wedged) —
                    # why an unready-recycle is in flight, not just that
                    "unready_reasons": rt.supervisor.unready_reasons(),
                    # the SLO engine's live burn gauges (docs/
                    # OBSERVABILITY.md "SLOs and burn rates") — what
                    # `tpu-life top` paints its breach table from
                    "slo": rt.supervisor.slo_status(),
                },
            )
            return
        if path == "/readyz":
            self._require(method, "GET", path)
            ready = rt.supervisor.ready_workers()
            if rt.draining or not ready:
                code = "draining" if rt.draining else "no_ready_workers"
                self._send_json(
                    503,
                    {
                        "ready": False,
                        "draining": rt.draining,
                        "workers_ready": len(ready),
                        "error": {"code": code, "message": f"fleet is {code}"},
                    },
                    retry_after=1.0,
                )
            else:
                self._send_json(
                    200,
                    {
                        "ready": True,
                        "draining": False,
                        "workers_ready": len(ready),
                    },
                )
            return
        if path == "/metrics":
            self._require(method, "GET", path)
            self._send_text(200, rt.merged_metrics(), "text/plain; version=0.0.4")
            return
        if path == ROUTE_REGISTER:
            # wire registration (docs/FLEET.md "Cross-host topology"):
            # the body is the worker's startup JSON line — the contract
            # that already existed IS the handshake
            self._require(method, "POST", path)
            self._send_json(200, rt.supervisor.register_worker(self._read_json()))
            return
        if path == ROUTE_HEARTBEAT:
            self._require(method, "POST", path)
            doc = self._read_json()
            worker = doc.get("worker")
            if not isinstance(worker, str):
                raise fl_errors.bad_registration(
                    f"heartbeat needs a worker name, got {worker!r}"
                )
            try:
                generation = int(doc.get("generation"))
            except (TypeError, ValueError):
                raise fl_errors.bad_registration(
                    f"heartbeat needs an integer generation, got "
                    f"{doc.get('generation')!r}"
                ) from None
            self._send_json(200, rt.supervisor.heartbeat(worker, generation))
            return
        if path == ROUTE_SESSIONS:
            self._require(method, "POST", path)
            body = self._read_body()
            # the router MINTS the per-session trace id (honoring a
            # client-supplied X-Trace-Id, validated typed) — the root of
            # the session's cross-process journey
            from tpu_life_torch.gateway.protocol import parse_trace_id

            trace_id = parse_trace_id(self.headers.get("X-Trace-Id"))
            if trace_id is None:
                trace_id = obs.new_trace_id()
            status, retry_after, doc = rt.route_submit(body, api_key, trace_id)
            self._send_json(status, doc, retry_after=retry_after)
            return
        if path.startswith(ROUTE_SESSIONS + "/"):
            rest = path[len(ROUTE_SESSIONS) + 1 :]
            if "/" not in rest:
                if method not in ("GET", "DELETE"):
                    raise gw_errors.method_not_allowed(method, path)
                try:
                    status, retry_after, doc = rt.route_pinned(
                        method, rest, "", api_key
                    )
                except ApiError as e:
                    if method == "GET" and e.code == "migrating":
                        # a plain poll mid-migration answers 200 with a
                        # synthetic running view — the poll-until-done
                        # client loop never sees the failover at all
                        self._send_json(200, rt.migrating_view(rest))
                        return
                    raise
                self._send_json(status, doc, retry_after=retry_after)
                return
            fsid, _, tail = rest.partition("/")
            if tail == "result":
                self._require(method, "GET", path)
                suffix = "/result" + (f"?{query}" if query else "")
                status, retry_after, doc = rt.route_pinned(
                    method, fsid, suffix, api_key
                )
                self._send_json(status, doc, retry_after=retry_after)
                return
            if tail == "cells":
                # mid-run steering (docs/STREAMING.md): forward the cell
                # mask verbatim to the exact worker that owns the session
                self._require(method, "PATCH", path)
                body = self._read_body()
                status, retry_after, doc = rt.route_pinned(
                    "PATCH", fsid, "/cells", api_key, body=body
                )
                self._send_json(status, doc, retry_after=retry_after)
                return
            if tail == "stream":
                self._require(method, "GET", path)
                self._stream(rt, fsid, query)
                return
        raise gw_errors.not_found(f"no route for {path}")

    def _stream(self, rt: Router, fsid: str, query: str) -> None:
        """``GET /v1/sessions/{fsid}/stream`` — one watcher on the
        fan-out tier (docs/STREAMING.md): frames come off the sid's
        shared broadcast buffer, never a dedicated worker connection.
        Admission errors (404 / 409 migrating / 410) answer typed BEFORE
        the 200; after the header the connection belongs to the frame
        grammar."""
        from urllib.parse import parse_qs

        raw = parse_qs(query).get("cursor", ["0"])[0]
        try:
            cursor = int(raw)
        except ValueError:
            raise gw_errors.bad_request(
                "invalid_request", f"bad cursor {raw!r}"
            ) from None
        if cursor < 0:
            raise gw_errors.bad_request("invalid_request", "'cursor' must be >= 0")
        rt.resolve(fsid)  # typed 404/409/410 while an answer is still JSON
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        gen = rt.fanout.watch(fsid, cursor)
        try:
            for frame in gen:
                # chaos seam (docs/CHAOS.md ``watch.slow_reader``): a
                # seeded stall in THIS watcher's write loop — its cursor
                # falls behind the broadcast buffer and the shed path,
                # not the pump or its peer watchers, absorbs the damage
                stall = chaos.delay("watch.slow_reader")
                if stall > 0:
                    time.sleep(stall)
                self.wfile.write((json.dumps(frame) + "\n").encode())
                self.wfile.flush()
        finally:
            gen.close()

    def _require(self, method: str, expected: str, path: str) -> None:
        if method != expected:
            raise gw_errors.method_not_allowed(method, path)


# -- prometheus merging ------------------------------------------------------
def merge_prom_texts(sources: list[tuple[str | None, str]]) -> str:
    """Merge Prometheus text expositions into one valid document.

    ``sources`` is ``[(worker_label, text), ...]``; every sample from a
    labeled source gains ``worker="<label>"`` (a ``None`` label — the
    fleet's own registry — passes through untouched).  Samples are
    regrouped by family so each family appears once, under one ``# TYPE``
    line, with all workers' series contiguous — the exposition-format
    contract a real scraper enforces.
    """
    fams: dict[str, dict] = {}

    def fam_entry(name: str) -> dict:
        return fams.setdefault(
            name, {"help": None, "type": None, "samples": []}
        )

    def family_of(sample: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if sample.endswith(suffix) and sample[: -len(suffix)] in fams:
                return sample[: -len(suffix)]
        return sample

    for label, text in sources:
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("# HELP "):
                parts = line.split(" ", 3)
                entry = fam_entry(parts[2])
                if entry["help"] is None and len(parts) > 3:
                    entry["help"] = parts[3]
            elif line.startswith("# TYPE "):
                parts = line.split(" ", 3)
                entry = fam_entry(parts[2])
                if entry["type"] is None and len(parts) > 3:
                    entry["type"] = parts[3]
            elif line.startswith("#"):
                continue
            else:
                head, _, value = line.rpartition(" ")
                if not head:
                    continue
                brace = head.find("{")
                if brace >= 0:
                    name, labelpart = head[:brace], head[brace + 1 : -1]
                else:
                    name, labelpart = head, ""
                if label is not None:
                    worker_label = f'worker="{label}"'
                    labelpart = (
                        f"{worker_label},{labelpart}" if labelpart else worker_label
                    )
                fam_entry(family_of(name))["samples"].append(
                    (name, labelpart, value)
                )
    lines: list[str] = []
    for fam, entry in fams.items():
        if not entry["samples"]:
            continue
        if entry["help"] is not None:
            lines.append(f"# HELP {fam} {entry['help']}")
        if entry["type"] is not None:
            lines.append(f"# TYPE {fam} {entry['type']}")
        for name, labelpart, value in entry["samples"]:
            series = f"{name}{{{labelpart}}}" if labelpart else name
            lines.append(f"{series} {value}")
    return "\n".join(lines) + ("\n" if lines else "")


def _json_body(resp) -> dict:
    try:
        doc = json.loads(resp.read() or b"{}")
        return doc if isinstance(doc, dict) else {"value": doc}
    except (json.JSONDecodeError, OSError):
        return {}


def _error_code(doc: dict) -> str | None:
    err = doc.get("error")
    return err.get("code") if isinstance(err, dict) else None
