"""Typed serving errors — the contract boundary of ``tpu_life_torch.serve``.

The reference program has exactly one failure mode: the process dies.  A
serving layer needs *typed* rejections a caller can branch on: a full
queue is backpressure (retry later, shed load upstream), a bad board is a
client error (never retry), an unknown session id is a protocol bug.
Everything subclasses :class:`ServeError` so front-ends can catch the
whole family in one clause while tests assert the precise type.
"""

from __future__ import annotations


class ServeError(Exception):
    """Base class for every error the serving layer raises on purpose."""


class QueueFull(ServeError):
    """Backpressure: the admission queue is at capacity.

    Raised by ``submit`` *synchronously* — the request was never stored, so
    rejecting it bounds memory.  The caller should retry after draining or
    shed the request upstream.
    """


class Draining(ServeError):
    """Admission is closed: the service is draining toward shutdown.

    Raised by ``submit`` after :meth:`SimulationService.begin_drain` —
    in-flight sessions keep running to completion, but no new work is
    accepted.  Front-ends map this to 503 + ``Retry-After`` so a
    load-balanced client retries against a peer that is still admitting.
    """


class InsufficientMemory(ServeError):
    """Admission-time memory governance (docs/SERVING.md "Resource
    governance"): admitting this session's CompileKey would push the
    estimated engine footprint past ``ServeConfig.memory_budget_bytes``.

    Raised by ``submit`` *synchronously* — nothing is stored, so an XLA
    ``RESOURCE_EXHAUSTED`` at engine build time becomes a rejected
    request instead of a dead worker.  ``transient`` is the retry
    contract: True means the key would fit on an otherwise-idle service
    (other keys' engines are holding the budget — retry after they
    drain, HTTP 503 + Retry-After); False means this single session's
    engine alone can never fit the budget (HTTP 413, never retried).
    ``estimated_bytes`` / ``budget_bytes`` carry the arithmetic so
    clients and tests can see exactly what was refused.

    A permanent (413) rejection additionally carries the mesh hint
    (docs/SERVING.md "Mega-board sessions"): ``mesh_eligible`` is True
    when the board has a sharded path (deterministic or continuous) and
    a multi-device slice could hold it, and ``min_devices`` is the
    smallest such slice — so clients and the fleet router can
    distinguish "resubmit to a mesh-capable worker" from "hopeless".
    """

    def __init__(
        self,
        message: str,
        *,
        transient: bool,
        estimated_bytes: int,
        budget_bytes: int,
        mesh_eligible: bool = False,
        min_devices: int | None = None,
    ):
        super().__init__(message)
        self.transient = transient
        self.estimated_bytes = estimated_bytes
        self.budget_bytes = budget_bytes
        self.mesh_eligible = mesh_eligible
        self.min_devices = min_devices


class QuotaExceeded(ServeError):
    """Tenant QoS (docs/SERVING.md "Tenant QoS"): admitting this request
    would push its tenant past a declared quota.

    Raised by ``submit`` (``max_sessions`` / ``memory_fraction``) and
    ``stream_subscribe`` (``max_watchers``) *synchronously* — nothing is
    stored, exactly the QueueFull discipline.  Front-ends map it to 429
    ``quota_exceeded`` with Retry-After: the tenant's own earlier work
    must finish before more admits, so the wait is real, not overload.
    ``tenant`` / ``quota`` / ``limit`` carry the arithmetic for clients
    branching beyond the code.
    """

    def __init__(self, message: str, *, tenant: str, quota: str, limit):
        super().__init__(message)
        self.tenant = tenant
        self.quota = quota
        self.limit = limit


class SessionTimeout(ServeError):
    """A session exceeded its per-request deadline.

    Never raised to the submitter directly; recorded as the FAILED
    session's ``error`` so ``poll`` can report it (the submitter may long
    since have gone away — the timeout exists to reclaim its slot).
    """


class UnknownSession(ServeError):
    """``poll``/``cancel``/``result`` named a session id that was never
    issued by this service instance."""


class SessionFailed(ServeError):
    """Raised by ``result`` when the session terminated without a board
    (FAILED or CANCELLED); carries the session's recorded error string."""
