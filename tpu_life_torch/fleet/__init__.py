"""tpu_life_torch.fleet — multi-worker router with supervision and failover.

The horizontal-scale tier (docs/FLEET.md): a :class:`Supervisor` keeps N
``tpu-life gateway`` worker subprocesses alive (readyz health checks,
exponential-backoff restarts, a circuit breaker for crash loops) while a
:class:`Router` speaks the exact gateway HTTP protocol to clients and
routes each session to the least-loaded worker, pinning sid -> worker in
a :class:`SessionRegistry` so polls and results land on the right
backend.  One worker dying takes out only its own in-flight sessions
(typed ``worker_lost`` errors); everything else keeps completing, and the
restarted worker rejoins the rotation.

With a ``spill_dir`` configured, worker death is *masked*, not merely
isolated: each worker spills its live sessions through the checkpoint
contract, and a :class:`~tpu_life_torch.fleet.migrate.Migrator` resumes a dead
worker's intact spills on a survivor under the SAME fleet sid — the
unmodified client polls straight through a SIGKILL and the finished
board is byte-identical to the uninterrupted run (docs/FLEET.md
"durability").

:class:`Fleet` wires the pieces together and owns the drain choreography:
SIGTERM -> the router stops admitting, every worker drains gracefully,
processes are reaped, and the CLI exits 0.

With ``placement="auto"`` each worker also owns a DISJOINT device slice
(env overlay via the planner in ``fleet.placement``; restarts re-enter
the same slice), reports its resolved capacity back, and the router
weights least-depth routing by it — so total capacity is ``sum(per-worker
chips x per-worker batch capacity)`` and a multi-chip host is saturated
by one fleet; the ROADMAP's "heavy traffic" story is this tier stamped
out behind a real load balancer.
"""

from __future__ import annotations

import time

from tpu_life_torch import obs
from tpu_life_torch.fleet.balancer import LeastDepthBalancer
from tpu_life_torch.fleet.migrate import Migrator
from tpu_life_torch.fleet.placement import (
    Placement,
    PlacementError,
    parse_devices_per_worker,
    plan_placements,
)
from tpu_life_torch.fleet.registry import SessionRegistry
from tpu_life_torch.fleet.router import Router, merge_prom_texts
from tpu_life_torch.fleet.supervisor import (
    FleetConfig,
    Supervisor,
    Worker,
    WorkerState,
    propagate_signals,
)
from tpu_life_torch.runtime.metrics import log


class Fleet:
    """The assembled tier: supervisor + router + session registry, on one
    shared metrics registry (``fleet_workers`` / ``fleet_restarts_total``
    / ``fleet_routed_total`` / ``fleet_retry_total``)."""

    def __init__(self, config: FleetConfig | None = None):
        self.config = config or FleetConfig()
        self.run_id = obs.new_run_id()
        self.registry = obs.MetricsRegistry()
        # chaos observability (docs/CHAOS.md): router/supervisor/migrator
        # injections fired in THIS process surface in the merged /metrics
        from tpu_life_torch import chaos

        chaos.bind_registry(self.registry)
        self.supervisor = Supervisor(self.config, self.registry)
        self.sessions = SessionRegistry(self.config.max_pins)
        self.router = Router(
            self.config, self.supervisor, self.sessions, self.registry
        )
        self.migrator = None
        if (
            self.config.spill_dir is not None
            or self.config.spill_url is not None
        ):
            self.migrator = Migrator(
                spill_root=self.config.spill_dir,
                spill_url=self.config.spill_url,
                site=self.config.site,
                peers=self.config.peers,
                supervisor=self.supervisor,
                sessions=self.sessions,
                registry=self.registry,
                balancer=self.router.balancer,
                forward=self.router.forward,
                timeout_s=self.config.migrate_timeout_s,
                stuck_after_s=self.config.migrate_stuck_after_s,
            )
            self.router.migrator = self.migrator
            self.supervisor.on_worker_exit = self.migrator.worker_exit
        self.host, self.port = self.router.host, self.router.port

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.supervisor.start()
        self.router.start()
        log.info(
            "fleet: %d workers behind http://%s:%d (run_id=%s)",
            self.config.workers,
            self.host,
            self.port,
            self.run_id,
        )

    def wait_ready(self, timeout: float = 60.0, min_workers: int = 1) -> bool:
        """Block until at least ``min_workers`` workers answer ready."""
        deadline = time.monotonic() + timeout
        while len(self.supervisor.ready_workers()) < min_workers:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.05)
        return True

    def begin_drain(self) -> None:
        """Fleet-wide graceful drain: stop admitting at the router, then
        SIGTERM every worker (each finishes in-flight sessions, exits 0).
        Idempotent; block on :meth:`wait`."""
        self.router.begin_drain()
        self.supervisor.begin_drain()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the drain completed and every worker is reaped.
        The router keeps forwarding polls/results while workers finish."""
        return self.supervisor.wait(timeout)

    def close(self) -> None:
        self.router.close()
        self.supervisor.close()

    def install_signal_handlers(self) -> None:
        propagate_signals(self.begin_drain)

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        routed = {
            labels["worker"]: inst.value
            for labels, inst in self.registry.counter(
                "fleet_routed_total", labels=("worker",)
            ).series()
        }
        capacity = self.supervisor.capacities()
        out = {
            "run_id": self.run_id,
            "workers": self.supervisor.states(),
            "generations": {w.name: w.generation for w in self.supervisor.workers},
            "restarts": self.supervisor.restarts(),
            "routed": routed,
            "retries": self.registry.counter("fleet_retry_total").value,
            "sessions_pinned": len(self.sessions),
            # device placement (docs/FLEET.md): per-worker resolved
            # devices/kind + routing weight, and the aggregate chip
            # count (sums only when placement makes slices disjoint)
            "capacity": capacity,
            "devices_total": self.supervisor.devices_total(),
            # typed probe-refusal reasons (docs/FLEET.md): why any
            # in-flight unready-recycle fired (e.g. engine_wedged)
            "unready_reasons": self.supervisor.unready_reasons(),
        }
        if self.migrator is not None:
            out["migrations"] = {
                labels["outcome"]: inst.value
                for labels, inst in self.registry.counter(
                    "fleet_migrations_total", labels=("outcome",)
                ).series()
            }
        # autoscaling evidence (docs/FLEET.md "Autoscaling") — present
        # only when the loop (or a standby pool) is configured, so
        # classic fleets keep their summary shape byte-stable
        if self.config.standby or self.supervisor.autoscaler is not None:
            active, standby = self.supervisor.scale_counts()
            out["scale"] = {"active": active, "standby": standby}
            if self.supervisor.autoscaler is not None:
                out["scale"]["decisions"] = self.supervisor.autoscaler.decisions
        return out


__all__ = [
    "Fleet",
    "FleetConfig",
    "LeastDepthBalancer",
    "Migrator",
    "Placement",
    "PlacementError",
    "Router",
    "SessionRegistry",
    "Supervisor",
    "Worker",
    "WorkerState",
    "merge_prom_texts",
    "parse_devices_per_worker",
    "plan_placements",
]
