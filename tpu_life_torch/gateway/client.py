"""A well-behaved gateway client: urllib + retry/backoff, torch-free (the
port of ``tpu_life/gateway/client.py``).

The reference implementation of the retry contract the gateway publishes:
429 and 503 responses carry ``Retry-After``; a client that honors it (and
backs off exponentially when it's absent) rides out rate limiting, load
shedding, and a draining peer without hammering the front door.  400s are
client bugs and are never retried.

Everything is stdlib + numpy (board decode) — importable from any
machine that can reach the gateway, no torch required, same spirit as the
``stats`` toolchain.
"""

from __future__ import annotations

import json
import random
import socket
import time
import urllib.error
import urllib.request

import numpy as np

from tpu_life_torch.gateway import protocol
from tpu_life_torch.gateway.errors import backoff_delay, parse_retry_after

#: Statuses the client retries (with Retry-After / backoff): rate limit,
#: and the 503 family (queue full / shedding / draining).
RETRYABLE = frozenset({429, 503})


class GatewayError(Exception):
    """A non-retryable (or retries-exhausted) gateway response."""

    def __init__(
        self,
        status: int,
        code: str,
        message: str,
        *,
        retry_after: float | None = None,
    ):
        super().__init__(f"[{status} {code}] {message}")
        self.status = status
        self.code = code
        self.message = message
        self.retry_after = retry_after


class GatewayClient:
    """Talk to one gateway (or a fleet router — same protocol).
    ``retries`` bounds how many times a retryable response (429/503) or a
    connection refusal is retried; ``backoff`` is the base of the
    exponential fallback used when the server sent no ``Retry-After``,
    spread by bounded ``jitter`` so N clients bounced by the same
    shedding fleet don't synchronize into retry storms (an explicit
    ``Retry-After`` always wins, un-jittered — the server asked for that
    exact pacing).  ``sleep`` and ``rng`` are injectable so tests never
    wait and never flake."""

    def __init__(
        self,
        base_url: str,
        *,
        api_key: str | None = None,
        timeout: float = 30.0,
        retries: int = 4,
        backoff: float = 0.2,
        max_backoff: float = 5.0,
        jitter: float = 0.25,
        sleep=time.sleep,
        rng: random.Random | None = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        self.max_backoff = max_backoff
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.jitter = jitter
        self.sleep = sleep
        self.rng = rng or random.Random()

    # -- transport ---------------------------------------------------------
    def _request(
        self,
        method: str,
        path: str,
        body: dict | None = None,
        headers: dict | None = None,
    ) -> dict:
        url = self.base_url + path
        data = None if body is None else json.dumps(body).encode()
        attempt = 0
        while True:
            req = urllib.request.Request(url, data=data, method=method)
            req.add_header("Content-Type", "application/json")
            if self.api_key:
                req.add_header("X-API-Key", self.api_key)
            for k, v in (headers or {}).items():
                req.add_header(k, v)
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return json.loads(resp.read() or b"{}")
            except urllib.error.HTTPError as e:
                payload = _error_payload(e)
                err = GatewayError(
                    e.code,
                    payload.get("code", "http_error"),
                    payload.get("message", str(e)),
                    retry_after=parse_retry_after(e.headers),
                )
                if e.code not in RETRYABLE or attempt >= self.retries:
                    raise err from None
                wait = err.retry_after
            except (urllib.error.URLError, ConnectionError, socket.timeout) as e:
                # a refused connection means the server never saw the
                # request — always safe to retry (normal during gateway
                # startup or a rolling restart).  Anything else (timeout,
                # reset mid-exchange) may have been PROCESSED: re-POSTing
                # /v1/sessions would silently create a duplicate session,
                # so only idempotent methods retry those.
                reason = getattr(e, "reason", e)
                refused = isinstance(reason, ConnectionRefusedError)
                retryable = refused or method in ("GET", "DELETE")
                if not retryable or attempt >= self.retries:
                    raise GatewayError(
                        0, "unreachable", f"{url}: {e}"
                    ) from None
                wait = None
            attempt += 1
            if wait is None:
                # no Retry-After: the shared jittered-exponential formula
                # (gateway.errors.backoff_delay — the migrator and remote
                # spill backend pace on the same curve)
                wait = backoff_delay(
                    attempt,
                    base=self.backoff,
                    cap=self.max_backoff,
                    jitter=self.jitter,
                    rng=self.rng,
                )
            self.sleep(wait)

    # -- the API -----------------------------------------------------------
    def submit(
        self,
        *,
        board: np.ndarray | None = None,
        rule: str = "conway",
        steps: int,
        timeout_s: float | None = None,
        size: int | None = None,
        height: int | None = None,
        width: int | None = None,
        seed: int | None = None,
        density: float | None = None,
        temperature: float | None = None,
        trace_id: str | None = None,
        scheduled_edits: list | None = None,
    ) -> str:
        """Create a session (inline board, or seeded geometry); returns sid.

        ``seed`` and ``temperature`` are the stochastic-tier fields
        (docs/STOCHASTIC.md): seed names the counter-based PRNG stream
        (and, for seeded geometry, the staged board); temperature is the
        per-session ising scalar.  ``trace_id`` rides the ``X-Trace-Id``
        header (docs/OBSERVABILITY.md "Distributed tracing"): the router
        honors it as the session's journey id instead of minting one —
        how a client correlates ITS request id with the fleet's trace.
        """
        req: dict = {"rule": rule, "steps": steps}
        if timeout_s is not None:
            req["timeout_s"] = timeout_s
        if temperature is not None:
            req["temperature"] = temperature
        if seed is not None:
            req["seed"] = seed
        if scheduled_edits is not None:
            # pre-scheduled steering (docs/STREAMING.md): the worker
            # applies each [step, cells] entry at exactly that step via
            # the freeze-mask seam, as if PATCHed live at that moment
            req["scheduled_edits"] = scheduled_edits
        if board is not None:
            req["board"] = board_rows(board)
        else:
            for k, v in (
                ("size", size),
                ("height", height),
                ("width", width),
                ("density", density),
            ):
                if v is not None:
                    req[k] = v
        headers = {"X-Trace-Id": trace_id} if trace_id is not None else None
        resp = self._request("POST", "/v1/sessions", req, headers=headers)
        return resp["session"]

    def poll(self, sid: str) -> dict:
        return self._request("GET", f"/v1/sessions/{sid}")

    def result(self, sid: str, fmt: str = "raw") -> dict:
        return self._request("GET", f"/v1/sessions/{sid}/result?format={fmt}")

    def result_board(self, sid: str) -> np.ndarray:
        """The finished session's board, byte-decoded from the raw payload."""
        return protocol.decode_result(self.result(sid, fmt="raw"))

    def cancel(self, sid: str) -> bool:
        return bool(self._request("DELETE", f"/v1/sessions/{sid}")["cancelled"])

    def edit_cells(self, sid: str, cells: list) -> dict:
        """Mid-run steering (docs/STREAMING.md): PATCH a list of
        ``[row, col, value]`` triples onto the running board; applied
        between chunks and recorded in the session's edit log."""
        return self._request(
            "PATCH", f"/v1/sessions/{sid}/cells", {"cells": cells}
        )

    def stream(self, sid: str, *, cursor: int = 0):
        """Watch a session live: a generator of frame dicts off the
        chunked ndjson delta stream (docs/STREAMING.md) — keyframes,
        deltas, edit markers, ``frame_gap`` resyncs, and the terminal
        ``end``.  One connection, no retries: a transport drop
        mid-stream surfaces as :class:`GatewayError` so the caller can
        reconnect with ``cursor`` set to the next sequence it needs
        (the server fast-forwards and re-keys).  Non-2xx admission
        responses (404 unknown sid, 503 watcher-buffer pressure) raise
        the usual typed error."""
        url = f"{self.base_url}/v1/sessions/{sid}/stream?cursor={int(cursor)}"
        req = urllib.request.Request(url, method="GET")
        if self.api_key:
            req.add_header("X-API-Key", self.api_key)
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            payload = _error_payload(e)
            raise GatewayError(
                e.code,
                payload.get("code", "http_error"),
                payload.get("message", str(e)),
                retry_after=parse_retry_after(e.headers),
            ) from None
        except (urllib.error.URLError, ConnectionError, socket.timeout) as e:
            raise GatewayError(0, "unreachable", f"{url}: {e}") from None
        try:
            with resp:
                for line in resp:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        # a torn frame (connection died mid-line) — the
                        # reconnect-with-cursor contract, not a parse bug
                        raise GatewayError(
                            0, "stream_torn", f"{sid}: torn frame mid-stream"
                        ) from None
        except (ConnectionError, socket.timeout, OSError) as e:
            raise GatewayError(0, "stream_torn", f"{sid}: {e}") from None

    def wait(self, sid: str, *, interval: float = 0.05, timeout: float = 120.0) -> dict:
        """Poll until the session is terminal; returns the final view."""
        deadline = time.monotonic() + timeout
        while True:
            view = self.poll(sid)
            if view["finished"]:
                return view
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"session {sid} still {view['state']} after {timeout}s"
                )
            self.sleep(interval)

    def healthz(self) -> dict:
        return self._request("GET", "/healthz")

    def readyz(self) -> dict:
        """Raises :class:`GatewayError` (503, retries exhausted) while
        draining — readiness is a yes/no the LB asks, not a retry loop."""
        return self._request("GET", "/readyz")

    def metrics(self) -> str:
        req = urllib.request.Request(self.base_url + "/metrics")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read().decode()


def board_rows(board: np.ndarray) -> list:
    """int8 board -> rows-of-digit-strings (the compact inline encoding);
    float32 (continuous-tier) boards -> nested float lists — the wire
    shape ``parse_board`` accepts for continuous rules."""
    board = np.asarray(board)
    if board.ndim != 2:
        raise ValueError(f"board must be 2-D, got shape {board.shape}")
    if np.issubdtype(board.dtype, np.floating):
        return [[float(c) for c in row] for row in board]
    if board.min(initial=0) < 0 or board.max(initial=0) > 9:
        raise ValueError("inline boards carry digit states 0..9")
    return ["".join(str(int(c)) for c in row) for row in board]


def _error_payload(e: urllib.error.HTTPError) -> dict:
    try:
        doc = json.loads(e.read() or b"{}")
        return doc.get("error", {}) if isinstance(doc, dict) else {}
    except (json.JSONDecodeError, OSError):
        return {}
