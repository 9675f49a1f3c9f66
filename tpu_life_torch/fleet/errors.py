"""Fleet-level typed errors — the router's additions to the gateway contract.

The router speaks the exact gateway error envelope
(:class:`tpu_life_torch.gateway.errors.ApiError`), so an unmodified
``GatewayClient`` sees fleet failures as the same typed JSON it already
handles.  The fleet adds failure modes a single gateway cannot have:

- ``worker_lost`` (410): the worker holding a pinned session died (crash,
  SIGKILL, restart) and the session could NOT be migrated.  Terminal and
  never retried; the ``reason`` field says why durability didn't cover
  it — ``never_snapshotted`` (death before the first spill),
  ``spill_corrupt`` (every snapshot failed the CRC/size intact check),
  ``migration_failed`` (no survivor could take it), or
  ``spill_disabled`` (the fleet runs without a spill dir, so every
  worker death is terminal for its sessions — the pre-durability
  behavior).
- ``migrating`` (409): the pinned worker died but its spilled sessions
  are being resumed on a survivor — retry after ``Retry-After`` and the
  original sid keeps working.  (Plain GET polls are answered with a
  synthetic in-progress view instead, so a poll-until-done client rides
  straight through the kill.)
- ``fleet_unavailable`` (503): every worker refused the submission
  (shedding, queue-full, or draining).  Retryable with ``Retry-After`` —
  the fleet-wide twin of a single gateway's ``overloaded``.
- ``upstream_error`` (502): a worker failed *mid-exchange* (timeout,
  reset) so the request may have been processed.  NOT retried by the
  router — re-forwarding a submit that may already have created a session
  would silently duplicate it (the same no-duplicate rule the client
  applies to its own retries).
"""

from __future__ import annotations

from tpu_life_torch.gateway.errors import ApiError


def worker_lost(worker: str, sid: str, reason: str = "spill_disabled") -> ApiError:
    return ApiError(
        410,
        "worker_lost",
        f"session {sid} was pinned to worker {worker}, which is gone, and "
        f"could not be recovered ({reason}); its in-flight state is lost — "
        f"resubmit to start over",
        extra={"reason": reason},
    )


def migrating(sid: str, retry_after: float = 0.5) -> ApiError:
    return ApiError(
        409,
        "migrating",
        f"session {sid} is being migrated from a dead worker to a "
        f"survivor; retry shortly — the same session id stays valid",
        retry_after=retry_after,
    )


def fleet_unavailable(tried: int, retry_after: float = 1.0) -> ApiError:
    return ApiError(
        503,
        "fleet_unavailable",
        f"all {tried} ready workers refused the submission (shedding or "
        f"draining); the fleet is protecting in-flight sessions",
        retry_after=retry_after,
    )


def no_ready_workers(total: int) -> ApiError:
    return ApiError(
        503,
        "fleet_unavailable",
        f"no ready workers ({total} supervised); retry shortly",
        retry_after=1.0,
    )


def upstream_error(worker: str, detail: str) -> ApiError:
    return ApiError(
        502,
        "upstream_error",
        f"worker {worker} failed mid-request ({detail}); the request may "
        f"or may not have been processed — not retried to avoid duplicates",
    )


def unknown_session(sid: str) -> ApiError:
    return ApiError(404, "unknown_session", f"no session {sid!r} in this fleet")


def lease_expired(worker: str, generation: int) -> ApiError:
    """The generation fence (docs/FLEET.md "Cross-host topology"): a
    heartbeat from a ``(worker, generation)`` whose lease already expired
    is REFUSED — its sessions were (or are being) rescued onto survivors,
    and accepting the heartbeat would re-admit a partitioned-but-alive
    worker into a fleet that re-homed its work: split-brain double
    execution.  410 (terminal for that incarnation): the worker's
    recourse is to drop its adopted state and re-register fresh."""
    return ApiError(
        410,
        "lease_expired",
        f"the lease of {worker} generation {generation} expired and its "
        f"sessions were re-homed; this incarnation is fenced — drop local "
        f"state and re-register for a fresh generation",
        extra={"worker": worker, "generation": generation},
    )


def draining(worker: str) -> ApiError:
    """The drain answer to a remote worker's heartbeat: the control plane
    is going away, but — unlike :func:`lease_expired` — the worker's
    sessions were NOT rescued anywhere.  Cancelling them would lose
    accepted work on a clean drain; the worker's correct move is to keep
    serving them to completion and re-register when (if) a control plane
    returns.  503 (retryable), so the generic transient path handles it."""
    return ApiError(
        503,
        "draining",
        f"this control plane is draining; {worker}'s lease is revoked but "
        f"its sessions were not re-homed — finish them and re-register "
        f"elsewhere (or here, after a restart)",
        retry_after=5.0,
    )


def peer_unreachable(peer: str, detail: str) -> ApiError:
    """A transient failure on the control-plane-to-peer link while
    proxying a pinned request (docs/FLEET.md "Cross-host topology").
    Unlike :func:`upstream_error`, every proxied request is an idempotent
    GET/DELETE — re-asking cannot duplicate anything — so this is a
    retryable 503, and an unmodified poll-until-done client rides through
    a link blip (or a healing partition) the same way it rides through a
    migration."""
    return ApiError(
        503,
        "peer_unreachable",
        f"peer control plane {peer} unreachable ({detail}); the session "
        f"may be running fine there — retry shortly",
        retry_after=0.5,
    )


def unknown_worker(worker: str) -> ApiError:
    return ApiError(
        404, "unknown_worker", f"no registered worker {worker!r} in this fleet"
    )


def bad_registration(message: str) -> ApiError:
    return ApiError(400, "bad_registration", message)
