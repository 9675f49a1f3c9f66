"""The HTTP front door: admission control in front of the batch scheduler
(the port of ``tpu_life/gateway/server.py``: the same routes, envelopes,
status codes and drain; the devices it reports are the service's own).

Dependency-free (stdlib ``http.server`` + threads), because the point is
the *shape*, not the framework: an inference-style serving stack is a
saturated continuous-batching core behind a traffic layer that admits,
sheds, and paces outside load (the throughput of the card only survives
contact with real clients if overload turns into typed 429/503s instead
of queue collapse).  The module imports no torch by itself (the service
is a type annotation here), so the HTTP spill store, which shares its
JSON envelope, runs without torch.

Threading model — one pump, many handlers::

    handler threads (ThreadingHTTPServer, one per connection)
        │  submit / poll / result / cancel        (service verbs, locked)
        ▼
    SimulationService  ◄── ONE background pump thread (all device work)

The service's internal lock is the seam: handler threads only call the
verbs, the pump thread owns every scheduling round, so the engine's
one-compile-per-CompileKey invariant never meets concurrent device work.

Admission pipeline for ``POST /v1/sessions`` (cheapest rejection first)::

    draining? -> 503   rate limit -> 429+Retry-After   shed -> 503
    body bound -> 413   parse/validate -> typed 400s   QueueFull -> 503

Graceful drain (SIGTERM): admission closes (``/readyz`` flips to 503 so
load balancers stop routing here), in-flight sessions step to completion,
telemetry flushes (JSONL snapshot, prom file, trace), the process exits 0.
"""

from __future__ import annotations

import json
import signal
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import TYPE_CHECKING
from urllib.parse import parse_qs, urlsplit

from tpu_life_torch import chaos
from tpu_life_torch.gateway import errors as gw_errors
from tpu_life_torch.gateway import protocol
from tpu_life_torch.gateway.errors import ApiError, fmt_retry_after
from tpu_life_torch.gateway.limits import KeyedBuckets, LoadShedder
from tpu_life_torch.runtime.metrics import log
from tpu_life_torch.serve.errors import Draining
from tpu_life_torch.version import __version__

if TYPE_CHECKING:
    from tpu_life_torch.serve.service import SimulationService

#: Routes get ONE bounded label each (metrics cardinality): the pattern,
#: never the concrete path (session ids are unbounded).
ROUTE_SESSIONS = "/v1/sessions"
ROUTE_SESSION = "/v1/sessions/{sid}"
ROUTE_RESULT = "/v1/sessions/{sid}/result"
#: Live-session verbs (docs/STREAMING.md): the chunked ndjson delta
#: stream and the mid-run cell-edit steering verb.
ROUTE_STREAM = "/v1/sessions/{sid}/stream"
ROUTE_CELLS = "/v1/sessions/{sid}/cells"
#: The trace drain verb (docs/OBSERVABILITY.md "Distributed tracing"):
#: each GET takes (and clears) the worker's buffered span + flight rings.
ROUTE_TRACE = "/v1/debug/trace"
#: The series scrape verb (docs/OBSERVABILITY.md "Time series"):
#: cursor-based, NON-destructive reads of the worker's bounded ring of
#: periodic metric snapshots — repeatable, unlike the trace drain.
ROUTE_SERIES = "/v1/debug/series"


@dataclass
class GatewayConfig:
    host: str = "127.0.0.1"
    port: int = 8000  # 0 = ephemeral (tests); the bound port is Gateway.port
    api_rate: float = 0.0  # token-bucket refill per API key, tokens/s (0 = off)
    api_burst: float = 10.0  # bucket capacity (max burst per key)
    # queue-depth high-water mark for load shedding; None derives 80% of
    # the service's bounded queue, 0 disables
    shed_high_water: float | None = None
    max_body: int = protocol.MAX_BODY  # request-body byte bound (413 past it)
    pump_idle_s: float = 0.01  # pump-thread nap when no session is live
    # tenant QoS (docs/SERVING.md "Tenant QoS"): usually the SAME policy
    # object as the service's ``ServeConfig.qos`` — identity resolution
    # and the tiered shed ladder run here at the front door, quotas and
    # DRR in the service.  None keeps the gateway tenant-blind.
    qos: object | None = None


class Gateway:
    """Owns the HTTP server, the pump thread, and the admission valves.

    The service's registry is shared: gateway families (per-route request
    counters, latency histograms, shed/rate-limit counters) land next to
    the serve families, so ``GET /metrics`` — and the service's own
    ``prom_file`` / JSONL snapshot — expose one coherent instrument set.
    """

    def __init__(self, service: SimulationService, config: GatewayConfig | None = None):
        self.service = service
        self.config = config or GatewayConfig()
        registry = service.registry
        self._c_requests = registry.counter(
            "gateway_requests_total",
            "HTTP requests by route / method / status",
            labels=("route", "method", "status"),
        )
        self._h_latency = registry.histogram(
            "gateway_request_seconds",
            "wall seconds per HTTP request",
            labels=("route",),
        )
        self._c_limited = registry.counter(
            "gateway_rate_limited_total",
            "submissions bounced by the per-key token bucket (429)",
        )
        self._c_shed = registry.counter(
            "gateway_shed_total",
            "submissions shed at the queue-depth high-water mark (503)",
        )
        self._c_limited.labels()
        self._c_shed.labels()
        # resolved device count of this worker's backend (docs/FLEET.md
        # "Device placement"): set on first resolution, so it lands in
        # /metrics, the prom snapshot, AND the final JSONL registry
        # snapshot — which is how `tpu-life stats` sums a fleet's
        # aggregate device count from the per-worker sinks
        self._g_devices = registry.gauge(
            "serve_devices", "devices visible to this worker's backend"
        )
        self._device_info: tuple[int, str] | None = None
        self._device_thread: threading.Thread | None = None
        self.buckets = KeyedBuckets(self.config.api_rate, self.config.api_burst)
        high_water = self.config.shed_high_water
        if high_water is None:
            high_water = 0.8 * service.config.max_queue
        # registration is idempotent, so this is the SAME gauge family the
        # service sets every scheduling round — the obs queue-depth signal
        # is the shed input, exactly as a Prometheus alert would read it
        depth_gauge = registry.gauge("serve_queue_depth")
        self.shedder = LoadShedder(lambda: depth_gauge.value, high_water)
        # the shed ladder's lower rung (docs/SERVING.md "Tenant QoS"):
        # best-effort tenants shed at a fraction of the high-water mark,
        # so overload degrades the free tier before any guaranteed
        # tenant feels it.  Policy-less gateways never build the rung.
        self.qos = self.config.qos or getattr(service.config, "qos", None)
        self.shedder_soft: LoadShedder | None = None
        self._c_tenant_shed = None
        if self.qos is not None:
            self.shedder_soft = LoadShedder(
                lambda: depth_gauge.value,
                self.qos.best_effort_water * high_water,
            )
            # the service registers this family first (idempotent): the
            # gateway's front-door sheds land next to the service's
            # quota rejections in one per-tenant counter
            self._c_tenant_shed = registry.counter(
                "tenant_shed_total",
                "typed per-tenant sheds and quota rejections by reason "
                "(quota_sessions / quota_bytes / quota_watchers / "
                "shed_best_effort)",
                labels=("tenant", "reason"),
            )
        self._server = _GatewayHTTPServer(
            (self.config.host, self.config.port), _Handler
        )
        self._server.gateway = self
        self.host, self.port = self._server.server_address[:2]
        self._wake = threading.Event()
        self._drained = threading.Event()
        self._pump_thread: threading.Thread | None = None
        self._serve_thread: threading.Thread | None = None
        self._closed = False
        self.pump_error: Exception | None = None  # set by a pump crash

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Start the HTTP listener thread and the single pump thread."""
        self._pump_thread = threading.Thread(
            target=self._pump_loop, name="gateway-pump", daemon=True
        )
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="gateway-http",
            daemon=True,
        )
        self._pump_thread.start()
        self._serve_thread.start()
        self._device_thread = threading.Thread(
            target=self._resolve_devices, name="gateway-devices", daemon=True
        )
        self._device_thread.start()
        log.info(
            "gateway listening on http://%s:%d (run_id=%s)",
            self.host,
            self.port,
            self.service.run_id,
        )

    def begin_drain(self) -> None:
        """Stop admitting (``/readyz`` -> 503), finish in-flight sessions,
        then stop the listener.  Idempotent; returns immediately — callers
        block on :meth:`wait`."""
        self.service.begin_drain()
        self._wake.set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the drain completed and the listener stopped.
        Joins in small slices so OS signals still reach the main thread."""
        threads = [t for t in (self._pump_thread, self._serve_thread) if t]
        deadline = None if timeout is None else _monotonic() + timeout
        for t in threads:
            while t.is_alive():
                t.join(0.1)
                if deadline is not None and _monotonic() > deadline:
                    return False
        return True

    def close(self) -> None:
        """Release the socket and flush the service's telemetry."""
        if self._closed:
            return
        self._closed = True
        if self._serve_thread is not None:
            # shutdown() blocks on serve_forever's exit handshake, so it is
            # only safe once the listener thread actually ran
            self._server.shutdown()
        self._server.server_close()
        self.service.close()

    def install_signal_handlers(self) -> None:
        """SIGTERM / SIGINT -> graceful drain (main thread only)."""

        def _drain(signum, frame):
            log.info("gateway: signal %d — draining", signum)
            self.begin_drain()

        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)

    # -- the one pump ------------------------------------------------------
    def _pump_loop(self) -> None:
        """All device work lives here.  Runs rounds while sessions are
        live, naps (wakeable by submits) when idle, and exits — shutting
        the listener down — once draining AND idle."""
        svc = self.service
        while True:
            # sample draining BEFORE idle: once admission is closed, a
            # submit can no longer slip in behind an idle() observation —
            # sampled the other way around, a session admitted between the
            # two reads would be stranded at shutdown
            draining = svc.draining
            if svc.idle():
                if draining:
                    # flush before reporting empty: a chunk whose sessions
                    # were all cancelled mid-pipeline is still executing,
                    # and a drain that abandons it would race device work
                    # against interpreter teardown
                    svc.flush()
                    break
                self._wake.wait(self.config.pump_idle_s)
                self._wake.clear()
            else:
                # chaos seams (docs/CHAOS.md): a worker that dies without
                # warning (SIGKILL-grade — os._exit, no drain, no flush)
                # and one that wedges mid-round.  Both fire from the pump
                # loop because that is where a real worker death hurts:
                # sessions mid-flight, spills mid-cadence, sockets open.
                chaos.crash("worker.crash")
                hang = chaos.delay("worker.hang")
                if hang > 0:
                    log.warning("chaos: pump hanging %.1fs (worker.hang)", hang)
                    time.sleep(hang)
                try:
                    svc.pump()
                except Exception as e:
                    # a pump crash must not impersonate a healthy drain:
                    # log it, remember it (the CLI exits non-zero and the
                    # summary carries it), and shut down — a stepping-dead
                    # gateway that kept answering polls would only strand
                    # its clients more slowly.  The flight ring gets the
                    # verdict first, so the LAST capture (scrape or the
                    # close-time dump) names the cause of death.
                    from tpu_life_torch import obs

                    obs.flight.record(
                        "pump_crash", error=f"{type(e).__name__}: {e}"
                    )
                    log.exception("gateway: pump thread crashed")
                    self.pump_error = e
                    break
        self._drained.set()
        self._server.shutdown()

    def device_info(self, wait_s: float = 0.0) -> tuple[int, str] | None:
        """``(devices, kind)`` this worker's backend resolved, or None
        while resolution is still in flight — what the startup line and
        ``/readyz`` report to a fleet supervisor.

        Resolution runs on a BACKGROUND thread kicked off by
        :meth:`start`: the first device query can take minutes on a
        slow accelerator attach (and 180 s on a wedged plugin), and
        blocking the startup line or a readiness probe on it would get
        the worker killed by its supervisor's startup timeout — the
        exact worker this seam exists to place.  Callers that can
        afford a bounded wait (the CLI's startup line) pass ``wait_s``;
        probes pass 0 and report the fields once they exist.
        """
        t = self._device_thread
        if self._device_info is None and t is not None and wait_s > 0:
            t.join(wait_s)
        return self._device_info

    def _resolve_devices(self) -> None:
        from tpu_life_torch.utils.platform import device_info

        # the device the service's engines run on: the card's kind, or
        # the CPU under device="cpu"
        info = device_info(device=self.service.config.device)
        self._g_devices.set(float(info[0]))
        self._device_info = info

    def wake(self) -> None:
        self._wake.set()

    @property
    def drained(self) -> bool:
        return self._drained.is_set()


class _GatewayHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    gateway: Gateway  # attached right after construction


class JsonHandler(BaseHTTPRequestHandler):
    """Shared envelope plumbing for the repo's JSON HTTP fronts — the
    gateway and the fleet router speak the same wire envelope, and the
    Content-Length / 411 / 413 hygiene must not diverge between them."""

    protocol_version = "HTTP/1.1"
    log_tag = "http"

    def log_message(self, fmt, *args):  # noqa: N802 (stdlib name)
        log.debug("%s: %s %s", self.log_tag, self.address_string(), fmt % args)

    def _send_json(
        self, status: int, body: dict, *, retry_after: float | None = None
    ) -> None:
        payload = (json.dumps(body) + "\n").encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        if retry_after is not None:
            self.send_header("Retry-After", fmt_retry_after(retry_after))
        self.end_headers()
        self.wfile.write(payload)

    def _send_text(self, status: int, text: str, content_type: str) -> None:
        payload = text.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _read_sized_body(self, limit: int) -> bytes:
        """The raw request body, bounded BEFORE it is read (411/400/413)."""
        length = self.headers.get("Content-Length")
        if length is None:
            self.close_connection = True
            raise ApiError(411, "length_required", "Content-Length is required")
        try:
            n = int(length)
        except ValueError:
            self.close_connection = True
            raise ApiError(
                400, "invalid_request", f"bad Content-Length {length!r}"
            ) from None
        if n > limit:
            # the body is rejected UNREAD, so this keep-alive stream now
            # holds n bytes the next request parser would misread as a
            # request line — close instead of desyncing
            self.close_connection = True
            raise gw_errors.payload_too_large(n, limit)
        return self.rfile.read(n)


class _Handler(JsonHandler):
    server_version = f"tpu-life-gateway/{__version__}"
    log_tag = "gateway"

    @property
    def gw(self) -> Gateway:
        return self.server.gateway  # type: ignore[attr-defined]

    def _send_json(
        self, status: int, body: dict, *, retry_after: float | None = None
    ) -> None:
        body = dict(body)
        # every response carries the service's correlation id: a client
        # report ("session X was slow") joins the JSONL sink, the prom
        # snapshot and the trace file on one key
        body.setdefault("run_id", self.gw.service.run_id)
        super()._send_json(status, body, retry_after=retry_after)

    def _read_body(self) -> dict:
        raw = self._read_sized_body(self.gw.config.max_body)
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise gw_errors.bad_request(
                "invalid_json", f"request body is not valid JSON: {e}"
            ) from None

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
        # unrouted paths share ONE label: recording the raw path would let
        # any scanner mint unbounded series in the shared registry
        route, status = "unmatched", 500
        t0 = _monotonic()
        try:
            route, handler, kwargs = self._route(method, path, parts.query)
            status = handler(**kwargs)
        except ApiError as e:
            status = e.status
            try:
                self._send_json(e.status, e.body(), retry_after=e.retry_after)
            except (BrokenPipeError, ConnectionResetError):
                pass
        except (BrokenPipeError, ConnectionResetError):
            status = 499  # client went away mid-response (nginx's code)
        except Exception:
            log.exception("gateway: %s %s failed", method, path)
            status = 500
            try:
                self._send_json(
                    500,
                    {"error": {"code": "internal", "message": "internal error"}},
                )
            except (BrokenPipeError, ConnectionResetError):
                pass
        finally:
            gw = self.gw
            gw._c_requests.labels(
                route=route, method=method, status=str(status)
            ).inc()
            gw._h_latency.labels(route=route).observe(_monotonic() - t0)

    def _route(self, method: str, path: str, query: str):
        """(route label, bound handler, kwargs) — 404/405 raise here."""
        if path == "/healthz":
            if method != "GET":
                raise gw_errors.method_not_allowed(method, path)
            return "/healthz", self._healthz, {}
        if path == "/readyz":
            if method != "GET":
                raise gw_errors.method_not_allowed(method, path)
            return "/readyz", self._readyz, {}
        if path == "/metrics":
            if method != "GET":
                raise gw_errors.method_not_allowed(method, path)
            return "/metrics", self._metrics, {}
        if path == ROUTE_TRACE:
            if method != "GET":
                raise gw_errors.method_not_allowed(method, path)
            return ROUTE_TRACE, self._debug_trace, {}
        if path == ROUTE_SERIES:
            if method != "GET":
                raise gw_errors.method_not_allowed(method, path)
            raw = parse_qs(query).get("cursor", ["0"])[0]
            try:
                cursor = int(raw)
            except ValueError:
                raise gw_errors.bad_request(
                    "invalid_request", f"bad cursor {raw!r}"
                ) from None
            if cursor < 0:
                raise gw_errors.bad_request(
                    "invalid_request", "'cursor' must be >= 0"
                )
            return ROUTE_SERIES, self._debug_series, {"cursor": cursor}
        if path == ROUTE_SESSIONS:
            if method != "POST":
                raise gw_errors.method_not_allowed(method, path)
            return ROUTE_SESSIONS, self._create, {}
        if path.startswith(ROUTE_SESSIONS + "/"):
            rest = path[len(ROUTE_SESSIONS) + 1 :]
            if "/" not in rest:
                sid = rest
                if method == "GET":
                    return ROUTE_SESSION, self._poll, {"sid": sid}
                if method == "DELETE":
                    return ROUTE_SESSION, self._cancel, {"sid": sid}
                raise gw_errors.method_not_allowed(method, path)
            sid, _, tail = rest.partition("/")
            if tail == "result":
                if method != "GET":
                    raise gw_errors.method_not_allowed(method, path)
                fmt = parse_qs(query).get("format", ["rle"])[0]
                return ROUTE_RESULT, self._result, {"sid": sid, "fmt": fmt}
            if tail == "stream":
                if method != "GET":
                    raise gw_errors.method_not_allowed(method, path)
                raw = parse_qs(query).get("cursor", ["0"])[0]
                try:
                    cursor = int(raw)
                except ValueError:
                    raise gw_errors.bad_request(
                        "invalid_request", f"bad cursor {raw!r}"
                    ) from None
                if cursor < 0:
                    raise gw_errors.bad_request(
                        "invalid_request", "'cursor' must be >= 0"
                    )
                return ROUTE_STREAM, self._stream, {"sid": sid, "cursor": cursor}
            if tail == "cells":
                if method != "PATCH":
                    raise gw_errors.method_not_allowed(method, path)
                return ROUTE_CELLS, self._edit_cells, {"sid": sid}
        raise gw_errors.not_found(f"no route for {path}")

    # -- handlers (each returns the status it sent) ------------------------
    def _healthz(self) -> int:
        # liveness: the process is up and dispatching — true even while
        # draining (readiness is the signal that flips)
        self._send_json(200, {"status": "ok"})
        return 200

    def _readyz(self) -> int:
        # chaos seam: a worker that refuses its readiness probe while
        # alive and stepping — the supervisor's unready-recycle path.
        # 500 (not 503): the probe must read "unreachable", never the
        # graceful "draining" a real 503 means.
        if chaos.decide("worker.unready") is not None:
            chaos.record_fire("worker.unready", "refuse")
            raise ApiError(500, "chaos_unready", "chaos: injected unready probe")
        svc = self.gw.service
        wedged = getattr(svc, "wedged", None)
        if wedged is not None:
            # the wedge watchdog tripped (docs/SERVING.md "Resource
            # governance"): a settle window outlived its deadline.  500
            # with the machine-readable verdict — a supervisor probe
            # reads "unreachable" (never the graceful "draining") and
            # its unready-recycle + migration path rescues the sessions.
            raise ApiError(
                500,
                "engine_wedged",
                f"a device settle blocked past "
                f"{wedged.get('deadline_s')}s; this worker must be "
                f"recycled",
                extra=wedged,
            )
        if svc.draining:
            self._send_json(
                503,
                {
                    "ready": False,
                    "draining": True,
                    # the probe's yes/no plus the standard envelope, so a
                    # client library reports "draining", not a bare 503
                    "error": {"code": "draining", "message": "service is draining"},
                },
                retry_after=1.0,
            )
            return 503
        body = {"ready": True, "draining": False}
        info = self.gw.device_info()  # non-blocking: None while resolving
        if info is not None:
            # capacity feedback for a fleet supervisor: what THIS
            # worker's backend resolved (docs/FLEET.md placement).  The
            # fields appear once resolution lands — readiness must never
            # block behind a slow (or wedged) accelerator attach.
            body["devices"], body["device_kind"] = info
        self._send_json(200, body)
        return 200

    def _metrics(self) -> int:
        # live Prometheus text straight off the shared registry — the same
        # renderer --prom-file snapshots, now scrapeable over HTTP
        text = self.gw.service.registry.prom_text()
        self._send_text(200, text, "text/plain; version=0.0.4")
        return 200

    def _debug_trace(self) -> int:
        # the fleet trace-collection seam (docs/OBSERVABILITY.md): drain
        # this worker's buffered span + flight events to the scraper.
        # Destructive by design — each scrape is an increment, so the
        # supervisor's per-tick collection never duplicates an event.
        self._send_json(200, self.gw.service.drain_trace())
        return 200

    def _debug_series(self, cursor: int) -> int:
        # the fleet series-scrape seam (docs/OBSERVABILITY.md "Time
        # series"): snapshots with seq >= cursor off the worker's bounded
        # ring.  Non-destructive — the SCRAPER owns the cursor, so a
        # replayed or concurrent scrape reads the same snapshots.
        self._send_json(200, self.gw.service.read_series(cursor))
        return 200

    def _create(self) -> int:
        gw = self.gw
        svc = gw.service
        if svc.draining:
            raise gw_errors.from_serve_error(
                Draining("service is draining: no new sessions are admitted")
            )
        api_key = self.headers.get("X-API-Key", "anonymous")
        wait = gw.buckets.acquire(api_key)
        if wait > 0:
            gw._c_limited.inc()
            raise gw_errors.rate_limited(wait)
        # tenant identity (docs/SERVING.md "Tenant QoS"): the API key
        # resolves to a named tenant once, here — the name then rides
        # submit -> session -> view as a typed field
        tenant = None
        tenant_spec = None
        if gw.qos is not None:
            tenant_spec = gw.qos.resolve(api_key)
            tenant = tenant_spec.name
        # the shed ladder: best-effort tenants meet the lower rung
        # first, so guaranteed tenants only ever see the full high-water
        # shed (and an autoscaling fleet gets the reaction window the
        # lower rung buys)
        if (
            gw.shedder_soft is not None
            and tenant_spec is not None
            and not tenant_spec.guaranteed
        ):
            shed = gw.shedder_soft.check()
            if shed is not None:
                gw._c_shed.inc()
                gw._c_tenant_shed.labels(
                    tenant=tenant_spec.label, reason="shed_best_effort"
                ).inc()
                raise gw_errors.shed_best_effort(
                    shed[0],
                    gw.shedder_soft.high_water,
                    shed[1],
                    tenant=tenant,
                )
        shed = gw.shedder.check()
        if shed is not None:
            gw._c_shed.inc()
            raise gw_errors.overloaded(shed[0], gw.shedder.high_water, shed[1])
        spec = protocol.parse_submit(self._read_body())
        # distributed-trace context (docs/OBSERVABILITY.md): the header
        # (what the fleet router forwards) wins over the body field (what
        # a resume request carries); with neither, the gateway mints one
        # — every HTTP-submitted session has a journey id from birth
        trace_id = protocol.parse_trace_id(self.headers.get("X-Trace-Id"))
        if trace_id is None:
            trace_id = spec.trace_id
        if trace_id is None:
            from tpu_life_torch import obs

            trace_id = obs.new_trace_id()
        try:
            sid = svc.submit(
                spec.board,
                spec.rule,
                spec.steps,
                timeout_s=spec.timeout_s,
                seed=spec.seed,
                temperature=spec.temperature,
                start_step=spec.start_step,
                trace_id=trace_id,
                edits=spec.edits,
                scheduled_edits=spec.scheduled_edits,
                stream_seq=spec.stream_seq,
                mesh_resume_dir=spec.resume_tiles_dir,
                tenant=tenant,
            )
        except Exception as e:  # typed serve errors -> typed HTTP
            raise gw_errors.from_serve_error(e) from e
        gw.wake()  # the pump may be napping — new work just arrived
        view = svc.poll(sid)
        body = protocol.render_view(view)
        self._send_json(201, body)
        return 201

    def _poll(self, sid: str) -> int:
        try:
            view = self.gw.service.poll(sid)
        except Exception as e:
            raise gw_errors.from_serve_error(e) from e
        self._send_json(200, protocol.render_view(view))
        return 200

    def _result(self, sid: str, fmt: str) -> int:
        svc = self.gw.service
        try:
            view = svc.poll(sid)
        except Exception as e:
            raise gw_errors.from_serve_error(e) from e
        if not view.finished:
            raise ApiError(
                409,
                "not_finished",
                f"session {sid} is {view.state.value} "
                f"({view.steps_done}/{view.steps} steps); poll until done",
                retry_after=0.1,
            )
        try:
            board = svc.result(sid)
        except Exception as e:
            raise gw_errors.from_serve_error(e) from e
        body = protocol.render_result(board, fmt, view.rule)
        body["session"] = sid
        self._send_json(200, body)
        return 200

    def _stream(self, sid: str, cursor: int) -> int:
        """``GET /v1/sessions/{sid}/stream`` — the chunked ndjson delta
        stream (docs/STREAMING.md).  Subscribe is the admission point
        (404 unknown, 503 when the governor refuses the watcher
        buffer); after the 200 header the connection belongs to the
        frame grammar until ``end`` (or a ``stream.reset`` chaos drop).
        The handler thread only ever blocks on the hub's condition —
        never on the service lock — so a slow reader cannot stall the
        pump."""
        svc = self.gw.service
        try:
            svc.stream_subscribe(sid, cursor=cursor)
        except Exception as e:
            raise gw_errors.from_serve_error(e) from e
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            # chunkless streaming: no Content-Length, so the connection
            # cannot be reused — say so and mean it
            self.send_header("Connection", "close")
            self.end_headers()
            self.close_connection = True
            while True:
                frames, cursor, eof = svc.stream_read(sid, cursor, timeout=0.25)
                for frame in frames:
                    line = (json.dumps(frame) + "\n").encode()
                    if chaos.decide("stream.reset") is not None:
                        # mid-FRAME connection drop: half a line, then a
                        # hard close — the client's resync path, not its
                        # happy path, is what this exercises
                        chaos.record_fire("stream.reset", "reset")
                        self.wfile.write(line[: max(1, len(line) // 2)])
                        self.wfile.flush()
                        raise BrokenPipeError("chaos: stream.reset")
                    self.wfile.write(line)
                if frames:
                    self.wfile.flush()
                if eof:
                    break
                if not frames and self.gw.drained:
                    # the pump exited (drain or crash): no frame will
                    # ever arrive again — release the watcher instead of
                    # spinning on an empty ring
                    break
            return 200
        finally:
            svc.stream_unsubscribe(sid)

    def _edit_cells(self, sid: str) -> int:
        """``PATCH /v1/sessions/{sid}/cells`` — mid-run steering
        (docs/STREAMING.md): a validated cell mask applied between
        chunks via the freeze-mask seam and recorded in the session's
        edit log."""
        gw = self.gw
        svc = gw.service
        body = self._read_body()
        if not isinstance(body, dict):
            raise gw_errors.bad_request(
                "invalid_request", "request body must be a JSON object"
            )
        cells = body.get("cells")
        if not isinstance(cells, list):
            raise gw_errors.bad_request(
                "invalid_request",
                "'cells' must be a list of [row, col, value] triples",
            )
        try:
            view = svc.edit_cells(sid, cells)
        except Exception as e:
            raise gw_errors.from_serve_error(e) from e
        gw.wake()  # the pump may be napping — the edit needs a round
        self._send_json(200, protocol.render_view(view))
        return 200

    def _cancel(self, sid: str) -> int:
        svc = self.gw.service
        try:
            stopped = svc.cancel(sid)
            view = svc.poll(sid)
        except Exception as e:
            raise gw_errors.from_serve_error(e) from e
        self._send_json(
            200,
            {"session": sid, "cancelled": stopped, "state": view.state.value},
        )
        return 200


def _monotonic() -> float:
    return time.monotonic()
