"""The two-control-plane chaos drill: failure masking across a host
boundary, machine-verified.

``run_cross_host_drill`` stands up the full cross-host topology on one
machine (docs/FLEET.md "Cross-host topology") and breaks it on a seeded
schedule:

- one **shared remote spill store** (:class:`SpillHTTPServer`) both
  control planes read and write through — the only channel spilled bytes
  cross the "host" boundary by;
- **control plane A**: a supervisor/router with ZERO locally-spawned
  workers and site prefix ``a-``, whose only capacity is a
  **wire-registered** gateway worker (a real ``tpu-life gateway
  --register`` subprocess holding a heartbeat-renewed lease);
- **control plane B**: a second supervisor/router with its own disjoint
  local workers and site prefix ``b-``, named as A's **peer**.

The seeded faults, all live at once in one run:

- ``lease.heartbeat.drop`` silences the registered worker's first beats:
  its lease expires, A fences the generation and migrates its sessions —
  and with no local survivors, every rescue crosses to PEER B, read out
  of the shared store.  When a later beat finally lands, the worker is
  refused with the typed 410 ``lease_expired`` (never re-admitted over
  its rescued sessions), drops its local copies, and re-registers fresh;
- ``lease.register.reset`` tears the first registration POST (the
  handshake must be retry-idempotent);
- ``spill.remote.timeout`` / ``spill.remote.torn_body`` break the wire
  spill path in both directions (write degrades one session to
  ``spill_disabled``; a torn read demotes to the predecessor snapshot);
- ``net.partition`` severs seeded per-pair links (router->worker,
  worker->store, registrar->control-plane);
- a drill-driven **SIGKILL** lands on the B worker that adopted rescued
  sessions, so the adopted work survives a SECOND death (the
  spill-on-adopt contract) via B's own remote-store migration.

The invariant set is then verified across the boundary:
``all_terminal`` / ``bit_identity`` / ``legal_410`` / ``no_lost_work`` /
``recovery_bounded`` / ``metrics_consistent`` (routed == accepted at A),
plus the cross-host-specific ``fencing`` invariant (the lease expired,
the reconnect was refused typed, the worker observed the fence and
re-registered).  Every summary carries the seed + plan digest that
replay the schedule verbatim.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from tpu_life_torch import chaos
from tpu_life_torch.chaos.drill import _Driller
from tpu_life_torch.fleet.registry import parse_fleet_sid
from tpu_life_torch.gateway.client import GatewayClient
from tpu_life_torch.runtime.metrics import log

#: The default cross-host fault mix: every family bounded (``times``) so
#: each seam fires AND heals inside one run — the drill's assertions need
#: "did it fire?" to be a deterministic question.
DEFAULT_CROSS_POINTS: dict[str, dict] = {
    # silence the registered worker's first five heartbeats: with the
    # drill's lease TTL the lease expires mid-run (sessions aboard),
    # and the sixth beat meets the fence
    "lease.heartbeat.drop": {"rate": 1.0, "mode": "drop", "times": 5},
    # the first registration POST is torn pre-send: the handshake retries
    "lease.register.reset": {"rate": 1.0, "mode": "reset", "times": 1},
    # one remote spill write times out per worker process (that session
    # degrades to spill_disabled); one downloaded snapshot body is torn
    # (the read demotes to its predecessor)
    "spill.remote.timeout": {"rate": 1.0, "mode": "timeout", "times": 1},
    "spill.remote.torn_body": {"rate": 1.0, "mode": "torn", "times": 1},
    # the first two consulted links per process sever, then heal
    "net.partition": {"rate": 1.0, "mode": "drop", "times": 2},
}


@dataclass
class CrossHostConfig:
    seed: int = 0
    #: local workers under control plane B (A has only the registered one)
    workers: int = 2
    det_sessions: int = 4
    ising_sessions: int = 1
    size: int = 16
    steps: int = 600
    kills: int = 1
    min_progress: int = 4
    points: dict | None = None
    #: the card's kernels by default, as in the single-plane drill
    backend: str = "cuda"
    device: str | None = None
    capacity: int = 8
    chunk_steps: int = 2
    spill_every: int = 1
    lease_ttl_s: float = 8.0
    resubmit_lost: int = 3
    recovery_bound_s: float = 90.0
    wait_timeout_s: float = 240.0
    migrate_stuck_after_s: float = 60.0
    workdir: str = "."
    summary_file: str | None = None


def _pkg_env() -> dict:
    env = dict(os.environ)
    pkg_root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = (
        pkg_root + os.pathsep + env["PYTHONPATH"]
        if env.get("PYTHONPATH")
        else pkg_root
    )
    return env


def run_cross_host_drill(cfg: CrossHostConfig) -> dict:
    """Run one seeded two-control-plane drill; returns the summary record
    (also appended to ``cfg.summary_file`` when set).  ``summary["ok"]``
    is the single verdict; on failure the summary names the seed and plan
    digest that replay the run verbatim."""
    from tpu_life_torch.fleet import Fleet, FleetConfig
    from tpu_life_torch.serve.spill_http import SpillHTTPServer

    if cfg.kills != 1:
        # the choreography is scripted — gateway SIGKILL, peer rescue,
        # then exactly ONE adopter SIGKILL on B (the spill-on-adopt
        # proof); a summary stamped with a kill count the drill never
        # performed would break the verbatim-replay contract
        raise chaos.ChaosError(
            f"the cross-host drill performs exactly one adopter SIGKILL "
            f"(--kills must be 1, got {cfg.kills}); --kills N is the "
            f"single-plane drill's knob"
        )
    points = DEFAULT_CROSS_POINTS if cfg.points is None else cfg.points
    # the driller shim: reuse the single-plane drill's workload maker,
    # client loop, oracle byte-checks and violation ledger verbatim
    d = _Driller(_shim(cfg, points))
    spec = d.plan.spec()
    t_start = time.monotonic()
    prev_env = os.environ.get(chaos.ENV_VAR)
    os.environ[chaos.ENV_VAR] = json.dumps(spec)  # subprocesses inherit
    chaos.arm(d.plan)  # this process: both routers/supervisors/migrators
    workdir = Path(cfg.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    evidence: dict = {}

    store = SpillHTTPServer(str(workdir / "store"))
    store.start()
    worker_args = (
        "--serve-backend", cfg.backend,
        "--capacity", str(cfg.capacity),
        "--chunk-steps", str(cfg.chunk_steps),
        "--max-queue", str(4 * (cfg.det_sessions + cfg.ising_sessions)),
        *(("--device", cfg.device) if cfg.device is not None else ()),
    )
    common = dict(
        port=0,
        worker_args=worker_args,
        spill_url=store.url,
        spill_every=cfg.spill_every,
        lease_ttl_s=cfg.lease_ttl_s,
        probe_interval_s=0.1,
        backoff_base_s=0.2,
        migrate_stuck_after_s=cfg.migrate_stuck_after_s,
    )
    fleet_b = Fleet(FleetConfig(
        workers=cfg.workers,
        site="b-",
        log_dir=str(workdir / "logs-b"),
        **common,
    ))
    proc = None
    worker_log = workdir / "registered-worker.log"
    try:
        fleet_b.start()
        fleet_a = Fleet(FleetConfig(
            workers=0,
            site="a-",
            peers=(f"http://127.0.0.1:{fleet_b.port}",),
            log_dir=str(workdir / "logs-a"),
            **common,
        ))
        d.fleet = fleet_a
        try:
            fleet_a.start()
            a_url = f"http://127.0.0.1:{fleet_a.port}"
            d.base_url = a_url
            # the wire-registered worker: control plane A's ONLY capacity.
            # Registration (not spawning) is how it joins; the startup
            # JSON contract is the handshake.
            argv = [
                sys.executable, "-m", "tpu_life_torch", "gateway",
                "--host", "127.0.0.1", "--port", "0",
                "--spill-url", store.url,
                "--register", a_url,
                *worker_args,
                "--spill-every", str(cfg.spill_every),
            ]
            with open(worker_log, "ab") as logf:
                proc = subprocess.Popen(
                    argv,
                    stdout=logf,
                    stderr=subprocess.STDOUT,
                    env=_pkg_env(),
                    start_new_session=True,
                )
            if not fleet_b.wait_ready(timeout=120, min_workers=cfg.workers):
                raise RuntimeError(
                    f"fleet B never ready: {fleet_b.supervisor.states()}"
                )
            if not fleet_a.wait_ready(timeout=120, min_workers=1):
                raise RuntimeError(
                    f"registered worker never joined A: "
                    f"{fleet_a.supervisor.states()}"
                )
            client = GatewayClient(a_url, retries=10)
            for item in d.items:
                d.submit_item(client, item)
            _drive_faults(cfg, d, fleet_a, fleet_b, evidence)
            _settle_items(cfg, d, client, fleet_a)
            d._scrape_injections()
            d.base_url = f"http://127.0.0.1:{fleet_b.port}"
            d._scrape_injections()  # B's workers' counters too
            d.base_url = a_url
            _check_books(cfg, d, fleet_a, fleet_b, evidence)
        finally:
            try:
                fleet_a.begin_drain()
                fleet_a.wait(timeout=60)
            finally:
                fleet_a.close()
    finally:
        try:
            fleet_b.begin_drain()
            fleet_b.wait(timeout=60)
        finally:
            fleet_b.close()
            if proc is not None:
                _stop_worker(proc, d, evidence, worker_log)
            store.close()
            chaos.disarm()
            if prev_env is None:
                os.environ.pop(chaos.ENV_VAR, None)
            else:
                os.environ[chaos.ENV_VAR] = prev_env
    elapsed = time.monotonic() - t_start
    verdicts = d.verdicts()
    verdicts["fencing"] = {
        "ok": not d.violations.get("fencing"),
        "violations": d.violations.get("fencing", []),
    }
    outcomes: dict[str, int] = {}
    for item in d.items:
        outcomes[item.outcome] = outcomes.get(item.outcome, 0) + 1
    done = outcomes.get("done", 0)
    summary = {
        "kind": "cross_host_drill",
        # the replay stamp: seed + canonical plan + digest — a failed CI
        # drill reruns locally from exactly these
        "seed": cfg.seed,
        "plan": spec,
        "plan_digest": d.plan.digest(),
        "workers_b": cfg.workers,
        "lease_ttl_s": cfg.lease_ttl_s,
        "kills": d.kills,
        "sessions": len(d.items),
        "accepted": d.accepted,
        "outcomes": outcomes,
        "resubmits": sum(i.resubmits for i in d.items),
        "delivered": sum(1 for i in d.items if i.delivered),
        "injections": _merged_injections(d),
        "lease": evidence.get("lease", {}),
        "peer_rescues": evidence.get("peer_rescues", 0),
        "registrar": evidence.get("registrar"),
        "invariants": verdicts,
        "ok": all(v["ok"] for v in verdicts.values()),
        "elapsed_s": elapsed,
        "sessions_per_sec": done / elapsed if elapsed > 0 else 0.0,
    }
    if cfg.summary_file:
        from tpu_life_torch import obs

        obs.ensure_parent(cfg.summary_file)
        with open(cfg.summary_file, "a") as f:
            f.write(json.dumps(summary) + "\n")
    return summary


def _shim(cfg: CrossHostConfig, points: dict):
    """A DrillConfig-shaped view of the cross-host config, so
    :class:`_Driller`'s workload/oracle/poll machinery is reused as-is."""
    from tpu_life_torch.chaos.drill import DrillConfig

    return DrillConfig(
        seed=cfg.seed,
        workers=cfg.workers,
        det_sessions=cfg.det_sessions,
        ising_sessions=cfg.ising_sessions,
        size=cfg.size,
        steps=cfg.steps,
        kills=cfg.kills,
        min_progress=cfg.min_progress,
        points=points,
        backend=cfg.backend,
        device=cfg.device,
        capacity=cfg.capacity,
        chunk_steps=cfg.chunk_steps,
        spill_every=cfg.spill_every,
        resubmit_lost=cfg.resubmit_lost,
        recovery_bound_s=cfg.recovery_bound_s,
        wait_timeout_s=cfg.wait_timeout_s,
        migrate_stuck_after_s=cfg.migrate_stuck_after_s,
        workdir=cfg.workdir,
    )


def _drive_faults(cfg, d, fleet_a, fleet_b, evidence: dict) -> None:
    """The fault choreography: wait out the chaos-driven lease expiry,
    observe the cross-host rescue, then SIGKILL the adopter on B."""
    sup_a = fleet_a.supervisor
    # 1. the heartbeat-loss expiry (chaos-driven): bounded wait
    deadline = time.monotonic() + cfg.lease_ttl_s * 3 + 60
    while sup_a._c_lease_expired.value < 1:
        if time.monotonic() > deadline:
            d.violate(
                "recovery_bounded",
                "the registered worker's lease never expired (heartbeat "
                "drops should have silenced it)",
            )
            return
        time.sleep(0.1)
    log.info("cross-host drill: lease expired — fence + migration underway")
    # 2. rescues cross to peer B (A has no local survivors until the
    # worker re-registers).  Not every session necessarily crosses — a
    # spill-degraded one is typed-lost instead — but at least one must.
    owners: set[str] = set()
    deadline = time.monotonic() + cfg.wait_timeout_s
    while time.monotonic() < deadline:
        pins = [
            fleet_a.migrator.peer_of(item.sid)
            for item in d.items
            if item.sid is not None
        ]
        owners = {
            pin.worker
            for p in pins
            if p is not None and (pin := parse_fleet_sid(p[1])) is not None
        }
        if owners or fleet_a.migrator.wait_idle(timeout=0.01):
            break
        time.sleep(0.1)
    evidence["peer_rescues"] = sum(
        1
        for item in d.items
        if item.sid is not None and fleet_a.migrator.peer_of(item.sid)
    )
    if not owners:
        d.violate(
            "no_lost_work",
            "no session was rescued onto the peer control plane",
        )
        return
    # 3. SIGKILL the B worker that adopted rescued sessions (seeded pick
    # among adopters): the second death — adopted work must survive it
    # through B's own remote-store migration (spill-on-adopt).
    ready_b = {w.name: w for w in fleet_b.supervisor.ready_workers()}
    candidates = sorted(n for n in owners if n in ready_b)
    if not candidates:
        d.violate("recovery_bounded", "no live adopter to SIGKILL on B")
        return
    victim = ready_b[candidates[d._draw("crosshost.kill", 0) % len(candidates)]]
    gen0 = victim.generation
    t0 = time.monotonic()
    os.kill(victim.proc.pid, signal.SIGKILL)
    log.info("cross-host drill: SIGKILL %s on control plane B", victim.name)
    deadline = t0 + cfg.recovery_bound_s
    while not (
        victim.generation > gen0
        and len(fleet_b.supervisor.ready_workers()) >= cfg.workers
    ):
        if time.monotonic() > deadline:
            d.kills.append({"worker": f"B/{victim.name}", "recovery_s": None})
            d.violate(
                "recovery_bounded",
                f"B not back to {cfg.workers} ready within "
                f"{cfg.recovery_bound_s:.0f}s of the SIGKILL",
            )
            return
        time.sleep(0.05)
    d.kills.append(
        {"worker": f"B/{victim.name}", "recovery_s": time.monotonic() - t0}
    )


def _settle_items(cfg, d, client, fleet_a) -> None:
    """Poll everything to terminal through A (original sids; rescued ones
    proxy to B), playing the documented resubmit recourse for typed
    losses — but only once A has capacity again (the re-registered
    worker), so the recourse is not wasted on a still-empty plane."""
    for item in d.items:
        if item.sid is None:
            continue
        d.poll_until_terminal(client, item)
    needs_recourse = any(
        i.outcome in ("lost", "failed") for i in d.items if i.sid is not None
    )
    if needs_recourse:
        deadline = time.monotonic() + cfg.recovery_bound_s
        while not fleet_a.supervisor.ready_workers():
            if time.monotonic() > deadline:
                break  # the resubmit itself will surface the violation
            time.sleep(0.1)
    for item in d.items:
        if item.sid is None:
            continue
        while (
            item.outcome in ("lost", "failed")
            and item.resubmits < cfg.resubmit_lost
        ):
            item.resubmits += 1
            if not d.submit_item(client, item):
                break
            d.poll_until_terminal(client, item)
    for item in d.items:
        if not item.delivered:
            d.violate(
                "no_lost_work",
                f"{item.tag} never yielded its oracle board "
                f"(final: {item.outcome} {item.detail})",
            )


def _check_books(cfg, d, fleet_a, fleet_b, evidence: dict) -> None:
    """The cross-host accounting: routed==accepted at A, the lease/fence
    evidence, the peer-rescue counter, and the injection floor."""
    stats = fleet_a.stats()
    routed = sum(stats.get("routed", {}).values())
    if routed != d.accepted:
        d.violate(
            "metrics_consistent",
            f"A's fleet_routed_total {routed} != accepted 201s {d.accepted}",
        )
    if any(i.outcome == "pending" for i in d.items):
        d.violate(
            "metrics_consistent", "an item finished the drill still pending"
        )
    sup_a = fleet_a.supervisor
    lease = {
        "expired": sup_a._c_lease_expired.value,
        "refused": sup_a._c_lease_refused.value,
        "registrations": sup_a._c_registrations.value,
    }
    evidence["lease"] = lease
    # the fence invariant: the lease expired, the stale generation is
    # terminally fenced, the reconnect was refused typed (the refusal
    # counter only moves on the 410 path), and a FRESH generation was
    # admitted — never the old one back
    if lease["expired"] < 1:
        d.violate("fencing", "no lease ever expired")
    if lease["refused"] < 1:
        d.violate(
            "fencing",
            "no fenced heartbeat was ever refused (the worker was never "
            "told, typed, that it lost its lease)",
        )
    if lease["registrations"] < 2:
        d.violate(
            "fencing",
            f"the fenced worker never re-registered "
            f"(registrations={lease['registrations']})",
        )
    if not sup_a.is_fenced("w0", 1):
        d.violate("fencing", "the first registered generation is not fenced")
    mig_a = stats.get("migrations", {})
    evidence["migrations_a"] = mig_a
    evidence["migrations_b"] = fleet_b.stats().get("migrations", {})
    if evidence.get("peer_rescues", 0) < 1 and mig_a.get("peer", 0) < 1:
        d.violate(
            "no_lost_work", "no cross-host (peer) rescue was ever recorded"
        )


def _merged_injections(d) -> dict[str, float]:
    """Injection evidence from every vantage: this process's live
    counters, both fleets' merged scrapes (which carry the supervisors'
    per-worker retention — exact across deaths), summed per point."""
    merged: dict[str, float] = {}
    for point, outcomes in chaos.counts().items():
        merged[point] = merged.get(point, 0.0) + float(sum(outcomes.values()))
    for point, total in d.injections_by_point().items():
        # the scraped view already includes this process's counters for
        # fleet-side points (the merged /metrics carries them); keep the
        # larger of the two vantages per point rather than double-adding
        merged[point] = max(merged.get(point, 0.0), total)
    return merged


def _stop_worker(proc, d, evidence: dict, worker_log: Path) -> None:
    """SIGTERM the registered worker, reap it, and read its summary line
    back for the worker-side fence evidence."""
    try:
        proc.terminate()
        proc.wait(timeout=30)
    except Exception:
        proc.kill()
        try:
            proc.wait(timeout=10)
        except Exception:
            log.warning("cross-host drill: registered worker unkillable")
    registrar = None
    try:
        for raw in worker_log.read_bytes().splitlines():
            raw = raw.strip()
            if not raw.startswith(b"{"):
                continue
            try:
                doc = json.loads(raw)
            except json.JSONDecodeError:
                continue
            if isinstance(doc.get("registrar"), dict):
                registrar = doc["registrar"]
    except OSError:
        pass
    evidence["registrar"] = registrar
    if registrar is None:
        d.violate(
            "fencing", "the registered worker left no registrar summary"
        )
    else:
        if registrar.get("fenced", 0) < 1:
            d.violate(
                "fencing",
                "the worker never observed a typed lease_expired fence "
                f"(registrar={registrar})",
            )
        if registrar.get("registrations", 0) < 2:
            d.violate(
                "fencing",
                f"the worker never re-registered after the fence "
                f"(registrar={registrar})",
            )
