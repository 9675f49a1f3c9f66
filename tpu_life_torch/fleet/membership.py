"""Wire-registered fleet membership: leases, fencing, the registrar.

The supervisor's original worker model is *ownership*: it spawns a
subprocess, so liveness is ``proc.poll()`` and identity is implicit.
Cross-host fleets break that — a worker on another machine registers
over HTTP instead of being spawned, and the control plane's knowledge of
it is only ever as fresh as its last message.  Membership therefore
becomes a **lease**:

- **Registration** (``POST /v1/fleet/register``): the worker sends
  exactly its startup JSON line (the ``mode: gateway`` document with its
  bound ``url`` / ``run_id`` / resolved ``devices``) — the contract that
  already existed *is* the handshake.  The control plane admits it as a
  fresh ``(worker, generation)``, grants a lease, and assigns the spill
  namespace that incarnation must write (so a later rescue knows where
  to read).
- **Heartbeats** (``POST /v1/fleet/heartbeat``): renew the lease.  A
  lease that expires un-renewed fires the SAME worker-exit hook a local
  process death does — the migrator rescues the spills — and the
  ``(worker, generation)`` is **fenced**.
- **Fencing**: a fenced incarnation's heartbeat is refused with the
  typed 410 ``lease_expired``, never silently re-admitted: its sessions
  were re-homed, and letting a partitioned-but-alive worker carry on
  would be split-brain double execution.  The namespaced ``wNgM-sK`` sid
  encoding makes the fence checkable end to end — every pin names the
  exact incarnation it trusts.

Locally-spawned workers keep working unchanged: the supervisor admits
their startup line through the same accounting (they hold a lease too,
renewed by its own liveness probes), so one code path decides membership
regardless of who started the process.

This module holds the **worker-side** :class:`Registrar` (a small
background client any ``tpu-life gateway --register URL`` runs) and the
shared helpers; the control-plane half lives on the
:class:`~tpu_life_torch.fleet.supervisor.Supervisor` (``register_worker`` /
``heartbeat``), wired to HTTP by the router.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

from tpu_life_torch import chaos
from tpu_life_torch.gateway.errors import backoff_delay
from tpu_life_torch.runtime.metrics import log

#: Default lease TTL granted to wire-registered workers.  Heartbeats run
#: at a third of it, so a lease survives two lost beats and the third
#: fences — responsive enough to matter, lazy enough not to flap.
LEASE_TTL_S = 15.0

ROUTE_REGISTER = "/v1/fleet/register"
ROUTE_HEARTBEAT = "/v1/fleet/heartbeat"


def heartbeat_every(ttl_s: float) -> float:
    return max(0.05, ttl_s / 3.0)


class Registrar:
    """The worker's membership client: register, heartbeat, re-register
    when fenced.

    Runs on a daemon thread beside the gateway.  The loop is two nested
    phases: acquire a grant (retrying refusals on the shared jittered
    backoff — the ``lease.register.reset`` chaos point fires here), then
    heartbeat until the control plane refuses.  On the typed 410
    ``lease_expired`` the worker's sessions were rescued elsewhere, so
    the registrar calls ``on_fenced`` (the gateway wires it to
    ``service.cancel_live`` — finishing the local copies would double-
    execute re-homed trajectories) and re-registers for a fresh
    generation, re-binding the spill namespace from the new grant.

    Everything is injectable (``http``, ``clock``, ``sleep``) so the
    state machine unit-tests without sockets.
    """

    def __init__(
        self,
        control_url: str,
        *,
        self_url: str,
        run_id: str | None = None,
        device_info=None,  # callable -> (devices, kind) | None
        on_grant=None,  # callable(grant dict) — spill-namespace rebinding
        on_fenced=None,  # callable(reason str) — drop re-homed sessions
        standby: bool = False,  # park in the standby pool, not the rotation
        timeout_s: float = 5.0,
        backoff_s: float = 0.2,
        max_backoff_s: float = 5.0,
        clock=time.monotonic,
        sleep=time.sleep,
        http=None,
    ):
        self.control_url = control_url.rstrip("/")
        self.self_url = self_url
        self.run_id = run_id
        self.device_info = device_info
        self.on_grant = on_grant
        self.on_fenced = on_fenced
        #: standby membership (docs/FLEET.md "Autoscaling"): registered
        #: and leased, but PARKED — the control plane keeps us out of
        #: the rotation until its autoscaler recruits the slot
        self.standby = standby
        self.timeout_s = timeout_s
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.clock = clock
        self.sleep = sleep
        self.http = http or self._default_http
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: the current grant: None until the first registration lands
        self.worker: str | None = None
        self.generation: int | None = None
        self.lease_ttl_s: float = LEASE_TTL_S
        #: observability for drills/tests: how often we were fenced
        self.fenced_count = 0
        self.registrations = 0

    # -- plumbing ------------------------------------------------------------
    def _default_http(self, path: str, body: dict) -> tuple[int, dict]:
        req = urllib.request.Request(
            self.control_url + path,
            data=json.dumps(body).encode(),
            method="POST",
        )
        req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return resp.status, _parse(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, _parse(e.read())

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="fleet-registrar", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- the state machine ----------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            grant = self._register_until_granted()
            if grant is None:
                return  # stopped
            self._heartbeat_until_fenced(grant)

    def _register_until_granted(self) -> dict | None:
        attempt = 0
        while not self._stop.is_set():
            doc = {
                "mode": "gateway",
                "url": self.self_url,
                "run_id": self.run_id,
            }
            if self.standby:
                doc["standby"] = True
            if self.worker is not None:
                # a re-registration claims the prior name: the control
                # plane bumps the generation on the same slot, exactly
                # like a local respawn
                doc["worker"] = self.worker
            if self.device_info is not None:
                info = self.device_info()
                if info is not None:
                    doc["devices"], doc["device_kind"] = info
            try:
                # chaos seam: the registration POST is reset before the
                # control plane ever sees it — the worker's only correct
                # move is to retry (registration is idempotent: the CP
                # mints the generation, so a lost answer costs a fenced
                # ghost generation, never a duplicate identity)
                if chaos.decide("lease.register.reset") is not None:
                    chaos.record_fire("lease.register.reset", "reset")
                    raise ConnectionResetError("chaos: register reset")
                if chaos.partitioned("registrar", self.control_url):
                    raise ConnectionRefusedError("chaos: net partition")
                status, body = self.http(ROUTE_REGISTER, doc)
            except Exception as e:  # noqa: BLE001 - transport noise: retry
                log.debug("registrar: register attempt failed: %s", e)
                status, body = 0, {}
            if status == 400 and self.worker is not None:
                # the claim itself was refused (e.g. a restarted control
                # plane now runs a LOCAL worker under our old name):
                # retrying the same claim forever would orphan us — drop
                # it and register fresh for whatever name is granted
                log.warning(
                    "registrar: registration claiming %s refused (%s); "
                    "dropping the stale claim",
                    self.worker,
                    _code(body),
                )
                self.worker = None
                self.generation = None
                continue
            if status == 200 and isinstance(body.get("worker"), str):
                self.worker = body["worker"]
                self.generation = int(body.get("generation", 0))
                self.lease_ttl_s = float(body.get("lease_ttl_s", LEASE_TTL_S))
                self.registrations += 1
                log.info(
                    "registrar: registered as %s gen %d (lease %.1fs)",
                    self.worker,
                    self.generation,
                    self.lease_ttl_s,
                )
                if self.on_grant is not None:
                    try:
                        self.on_grant(body)
                    except Exception:
                        log.exception("registrar: on_grant hook failed")
                return body
            attempt += 1
            self._nap(
                backoff_delay(
                    attempt, base=self.backoff_s, cap=self.max_backoff_s
                )
            )
        return None

    def _heartbeat_until_fenced(self, grant: dict) -> None:
        every = heartbeat_every(self.lease_ttl_s)
        while not self._stop.is_set():
            self._nap(every)
            if self._stop.is_set():
                return
            # chaos seam: the heartbeat is dropped on the floor — the
            # asymmetric partition where the worker believes it is fine
            # while the control plane hears silence.  Enough consecutive
            # drops expire the lease and the next delivered heartbeat
            # meets the fence.
            if chaos.decide("lease.heartbeat.drop") is not None:
                chaos.record_fire("lease.heartbeat.drop", "drop")
                continue
            if chaos.partitioned("registrar", self.control_url):
                continue
            try:
                status, body = self.http(
                    ROUTE_HEARTBEAT,
                    {"worker": self.worker, "generation": self.generation},
                )
            except Exception as e:  # noqa: BLE001 - transient: the lease
                # has slack for lost beats; a real partition ends at the
                # fence, not here
                log.debug("registrar: heartbeat failed: %s", e)
                continue
            if status == 200:
                continue
            if status == 410 and _code(body) == "lease_expired":
                self.fenced_count += 1
                log.warning(
                    "registrar: FENCED — %s gen %s lease expired and its "
                    "sessions were re-homed; dropping local state and "
                    "re-registering",
                    self.worker,
                    self.generation,
                )
                if self.on_fenced is not None:
                    try:
                        self.on_fenced("lease_expired")
                    except Exception:
                        log.exception("registrar: on_fenced hook failed")
                return  # back to registration with a fresh generation
            if status == 404:
                # the control plane has no record of us at all (it
                # restarted): nothing was rescued, so local sessions are
                # kept — but the lease is gone and only a fresh
                # registration restores capacity; looping here would
                # orphan the worker forever
                log.warning(
                    "registrar: control plane no longer knows %s gen %s "
                    "(%s); re-registering",
                    self.worker,
                    self.generation,
                    _code(body),
                )
                return
            log.debug(
                "registrar: heartbeat answered %s %s", status, _code(body)
            )

    def _nap(self, seconds: float) -> None:
        """Sleep in stop-aware slices (sleep is injectable for tests)."""
        if self.sleep is not time.sleep:
            self.sleep(seconds)
            return
        self._stop.wait(seconds)


def _parse(raw: bytes) -> dict:
    try:
        doc = json.loads(raw or b"{}")
        return doc if isinstance(doc, dict) else {}
    except json.JSONDecodeError:
        return {}


def _code(doc: dict) -> str | None:
    err = doc.get("error")
    return err.get("code") if isinstance(err, dict) else None
