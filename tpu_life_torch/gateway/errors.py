"""Typed HTTP error mapping — the gateway's contract boundary.

Every failure a client can see is an :class:`ApiError`: an HTTP status, a
stable machine-readable ``code`` (the thing clients branch on — status
codes are too coarse: 503 is both "queue full, retry" and "draining, go
elsewhere"), a human message, and an optional ``Retry-After`` hint.  The
server serializes it as one JSON envelope::

    {"error": {"code": "rate_limited", "message": "..."}, "run_id": "..."}

``from_serve_error`` is the single place the serving layer's typed
exceptions (``tpu_life_torch.serve.errors``) become HTTP semantics, so the
handler code never grows scattered ``except`` clauses with ad-hoc
status picks.
"""

from __future__ import annotations


class ApiError(Exception):
    """One client-visible failure: status + stable code + message.

    ``retry_after`` (seconds) becomes a ``Retry-After`` header when set —
    the backoff contract for 429/503 responses that
    :mod:`tpu_life_torch.gateway.client` honors.
    """

    def __init__(
        self,
        status: int,
        code: str,
        message: str,
        *,
        retry_after: float | None = None,
        extra: dict | None = None,
    ):
        super().__init__(message)
        self.status = status
        self.code = code
        self.message = message
        self.retry_after = retry_after
        # machine-readable qualifiers beyond the code (e.g. the fleet's
        # worker_lost ``reason``) — merged into the error object so
        # clients branching on code can refine on them without parsing
        # the human message
        self.extra = extra or {}

    def body(self) -> dict:
        return {
            "error": {"code": self.code, "message": self.message, **self.extra}
        }


def fmt_retry_after(seconds: float) -> str:
    """``Retry-After`` is integer seconds; always at least 1 so a client
    that honors it literally cannot busy-spin."""
    return str(max(1, int(seconds + 0.999)))


def parse_retry_after(headers) -> float | None:
    """Inverse of :func:`fmt_retry_after` — the one place the header is
    read, shared by the client and the fleet router so the semantics
    (numeric seconds only, None on anything else) cannot drift."""
    v = headers.get("Retry-After") if headers is not None else None
    if v is None:
        return None
    try:
        return float(v)
    except ValueError:
        return None


def backoff_delay(
    attempt: int,
    *,
    base: float,
    cap: float,
    jitter: float = 0.25,
    rng=None,
) -> float:
    """The retry pause for the ``attempt``-th retry (1-based): exponential
    from ``base``, spread by bounded multiplicative ``jitter`` so N peers
    bounced together don't re-arrive in lockstep, clamped to ``cap``
    AFTER jittering (the cap is a hard bound callers size against
    deadlines; downward jitter still spreads it).  The one backoff
    formula the client, the migrator's resume retry, and the remote
    spill backend all share — an explicit ``Retry-After`` always wins
    over it, un-jittered."""
    import random

    wait = base * (2 ** (max(1, attempt) - 1))
    if jitter:
        wait *= 1.0 + (rng or random).uniform(-jitter, jitter)
    return min(cap, wait)


def bad_request(code: str, message: str) -> ApiError:
    return ApiError(400, code, message)


def not_found(message: str) -> ApiError:
    return ApiError(404, "not_found", message)


def method_not_allowed(method: str, path: str) -> ApiError:
    return ApiError(
        405, "method_not_allowed", f"{method} is not supported on {path}"
    )


def payload_too_large(length: int, limit: int) -> ApiError:
    return ApiError(
        413,
        "payload_too_large",
        f"request body is {length} bytes; the limit is {limit}",
    )


def rate_limited(retry_after: float) -> ApiError:
    return ApiError(
        429,
        "rate_limited",
        "request rate exceeds this API key's token bucket; slow down",
        retry_after=retry_after,
    )


def overloaded(depth: float, high_water: float, retry_after: float) -> ApiError:
    return ApiError(
        503,
        "overloaded",
        f"queue depth {depth:g} is past the shed threshold {high_water:g}; "
        f"the service is protecting in-flight sessions",
        retry_after=retry_after,
    )


def shed_best_effort(
    depth: float, water: float, retry_after: float, *, tenant: str
) -> ApiError:
    """The lower rung of the shed ladder (docs/SERVING.md "Tenant QoS"):
    a best-effort tenant turned away while guaranteed tenants still
    admit.  Retryable by contract — capacity may return, or the fleet
    may scale up — so the router treats it as a refusal like
    ``overloaded``."""
    return ApiError(
        503,
        "shed_best_effort",
        f"queue depth {depth:g} is past the best-effort shed threshold "
        f"{water:g}; best-effort tenant {tenant!r} is shed first so "
        f"guaranteed tenants keep admitting",
        retry_after=retry_after,
        extra={"tenant": tenant},
    )


def from_serve_error(e: Exception) -> ApiError:
    """Serving-layer exception -> HTTP semantics (the one mapping table)."""
    from tpu_life_torch.serve.errors import (
        Draining,
        InsufficientMemory,
        QueueFull,
        QuotaExceeded,
        SessionFailed,
        UnknownSession,
    )

    if isinstance(e, QuotaExceeded):
        # the tenant's OWN declared ceiling (docs/SERVING.md "Tenant
        # QoS"), not service overload: 429 like the rate limiter, with
        # the arithmetic in the extra so clients see WHICH quota and
        # where the line is.  Retry-After is honest — the tenant's own
        # earlier work must retire before more admits.
        return ApiError(
            429,
            "quota_exceeded",
            str(e),
            retry_after=1.0,
            extra={"tenant": e.tenant, "quota": e.quota, "limit": e.limit},
        )

    if isinstance(e, InsufficientMemory):
        # the memory governor (docs/SERVING.md "Resource governance"):
        # transient pressure is a retryable 503 (other keys hold the
        # budget — come back after they drain); a session whose engine
        # can NEVER fit is a 413, not worth retrying.  One stable code
        # either way; the status and the `transient` flag carry the
        # retry semantics, the byte arithmetic rides in the extra.
        extra = {
            "transient": e.transient,
            "estimated_bytes": e.estimated_bytes,
            "budget_bytes": e.budget_bytes,
        }
        if e.transient:
            return ApiError(
                503, "insufficient_memory", str(e),
                retry_after=1.0, extra=extra,
            )
        # the never-fits 413 carries the mesh hint (docs/SERVING.md
        # "Mega-board sessions") so clients and the fleet router can
        # distinguish "resubmit to a mesh-capable fleet of >= min_devices
        # chips" from "hopeless"
        extra["mesh_eligible"] = bool(getattr(e, "mesh_eligible", False))
        if getattr(e, "min_devices", None) is not None:
            extra["min_devices"] = int(e.min_devices)
        return ApiError(413, "insufficient_memory", str(e), extra=extra)
    if isinstance(e, QueueFull):
        # backpressure: the bounded admission queue is the hard backstop
        # behind the shed threshold — same retry contract, same status
        return ApiError(503, "queue_full", str(e), retry_after=1.0)
    if isinstance(e, Draining):
        # a load-balanced client should retry against a peer, not wait here
        return ApiError(503, "draining", str(e), retry_after=1.0)
    if isinstance(e, UnknownSession):
        return ApiError(404, "unknown_session", str(e))
    if isinstance(e, SessionFailed):
        # terminal without a board (failed / cancelled): the session is
        # gone for good — 410, never retried
        return ApiError(410, "session_failed", str(e))
    from tpu_life_torch.models.rules import GeometryError

    if isinstance(e, GeometryError):
        # kernel-vs-board geometry (docs/RULES.md): the service's
        # re-check of what parse_submit already fronts — same typed code
        return bad_request("radius_too_large", str(e))
    if isinstance(e, ValueError):
        # the service's board/steps validation speaks ValueError
        return bad_request("invalid_request", str(e))
    raise e
