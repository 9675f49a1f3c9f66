"""The chaos drill: a seeded, machine-verified fleet-survival exercise.

``run_drill`` drives a REAL N-worker fleet (subprocess gateways behind
the router, their engines on the card unless ``device="cpu"`` asks for
the plain PyTorch versions, spill-backed failover on) under a seeded fault
schedule — the armed :mod:`tpu_life_torch.chaos` plan plus drill-driven
SIGKILLs — while a mixed det+ising workload with staggered budgets flows
through the standard client protocol.  Nothing in the serving stack is
modified for the drill; the faults land at the production seams.

The drill then checks the **invariants** (docs/CHAOS.md) that define
"robust" for this fleet:

- ``all_terminal``: every accepted session reaches a terminal
  observation (done / typed 410 / failed) within the wait budget — no
  sid polls "migrating" or "running" forever (the stuck-MIGRATING
  watchdog's contract).
- ``bit_identity``: every session observed DONE returns a board
  byte-identical to its solo oracle (``run_np`` / ``MCHostRunner``) —
  failover, resets and retries may delay an answer, never change it.
- ``legal_410``: every terminal loss is TYPED — a ``worker_lost`` 410
  carries a reason from the legal set, a failed session carries its
  error string.  Silent loss (a 404 for an accepted sid, an unreasoned
  410) is a violation.
- ``no_lost_work``: every workload item ultimately yields its oracle
  board.  Typed losses are recoverable by the documented client
  recourse — resubmit from scratch — and the drill plays that client,
  so "no lost accepted work" means: loss is bounded, typed, and always
  recoverable, never silent or sticky.
- ``recovery_bounded``: after each SIGKILL the supervisor returns the
  fleet to full ready strength within ``recovery_bound_s``.
- ``metrics_consistent``: the fleet's merged accounting adds up —
  ``fleet_routed_total`` equals the sessions the clients actually got
  accepted (201s), and the migration counters cover every post-kill
  outcome.

Every summary is stamped with the chaos **seed** and the plan
**digest**: a failed CI drill prints its seed, and rerunning with that
seed replays the exact injection schedule (docs/CHAOS.md "seed replay").
"""

from __future__ import annotations

import json
import os
import signal
import time
import urllib.error
import urllib.request
import zlib
from dataclasses import dataclass, field

import numpy as np

from tpu_life_torch import chaos, mc
from tpu_life_torch.gateway import protocol
from tpu_life_torch.gateway.client import GatewayClient
from tpu_life_torch.mc.engine import MCHostRunner
from tpu_life_torch.mc.prng import key_halves, threefry2x32
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops.reference import run_np
from tpu_life_torch.runtime.metrics import log

#: 410 reasons the durability contract is allowed to answer (docs/FLEET.md).
LEGAL_410_REASONS = frozenset(
    {"never_snapshotted", "spill_corrupt", "migration_failed", "spill_disabled"}
)

#: The default fault mix for ``tpu-life chaos`` / ``bench --chaos``: every
#: armed family fires a BOUNDED number of times (``times``), so the drill
#: exercises each seam without degenerating into pure noise — and the
#: bounds make "did every armed point actually fire?" a deterministic
#: question on any run long enough to reach each seam.
DEFAULT_POINTS: dict[str, dict] = {
    "spill.write": {"rate": 1.0, "mode": "enospc", "times": 1},
    "snapshot.corrupt": {"rate": 1.0, "mode": "bitflip", "times": 2},
    "router.submit.reset": {"rate": 1.0, "mode": "reset", "times": 2},
    "router.poll.reset": {"rate": 0.02, "mode": "mid_body"},
    # low-rate so the fault lands MID-flight (a first-dispatch wipeout
    # would just retest admission); bounded so one fault, not a storm
    "engine.dispatch": {"rate": 0.02, "mode": "fault", "times": 1},
}

#: The governor drill's fault mix (``tpu-life chaos --governor``,
#: docs/SERVING.md "Resource governance"): device OOMs that the
#: in-place recovery ladder must MASK (the worker survives, sessions
#: finish byte-identical on halved-chunk/host-demotion), and a wedged
#: settle that only the watchdog -> readyz-500 -> supervisor-recycle ->
#: migration path can rescue.  Low rates land the faults mid-flight;
#: ``seconds`` is far past any sane settle deadline so the wedge can
#: never clear itself by luck.
GOVERNOR_POINTS: dict[str, dict] = {
    "engine.oom": {"rate": 0.04, "mode": "oom", "times": 2},
    "engine.wedge": {"rate": 0.015, "mode": "sleep", "times": 1,
                     "seconds": 30.0},
}

#: The stream drill's fault mix (``tpu-life chaos --stream``,
#: docs/STREAMING.md "Chaos"): torn worker streams mid-frame (the
#: fan-out puller must reconnect at its cursor and the watcher must see
#: GAPLESS seqs) and a stalled router->watcher write (absorbed by the
#: broadcast buffer, never propagated to the pump).  ``seconds`` stays
#: well under the buffer's slack so the stall is exercised without
#: shedding the drill's own watchers.
STREAM_POINTS: dict[str, dict] = {
    "stream.reset": {"rate": 0.1, "mode": "reset", "times": 2},
    "watch.slow_reader": {"rate": 0.05, "mode": "sleep", "times": 2,
                          "seconds": 0.4},
}

#: The surge drill's fault mix (``tpu-life chaos --surge``,
#: docs/FLEET.md "Autoscaling"): one recruit refused at the worst moment
#: (the control loop must hold WITHOUT arming its cooldown and land the
#: recruit on the next tick) and one release steered onto the BUSIEST
#: worker instead of the idlest (graceful drain must still lose no
#: session).  Both fire in the fleet process — the autoscaler's seams.
SURGE_POINTS: dict[str, dict] = {
    "scale.recruit.fail": {"rate": 1.0, "mode": "refuse", "times": 1},
    "scale.release.race": {"rate": 1.0, "mode": "race", "times": 1},
}


@dataclass
class DrillConfig:
    seed: int = 0
    workers: int = 2
    det_sessions: int = 6
    ising_sessions: int = 2
    size: int = 20  # det board edge (ising boards are 16x16 — even dims)
    steps: int = 900  # base budget; staggered downward per session
    kills: int = 1
    min_progress: int = 8  # steps a victim must have banked before a kill
    points: dict | None = None  # chaos plan points (None = DEFAULT_POINTS)
    #: worker engine executor: the card's kernels by default (the port's
    #: departure: the JAX drill defaults to numpy, a CPU fleet)
    backend: str = "cuda"
    #: the workers' ``--device`` (None: the card; "cpu": the plain
    #: PyTorch versions of the kernels on the host)
    device: str | None = None
    capacity: int = 4
    chunk_steps: int = 2
    spill_every: int = 1
    resubmit_lost: int = 3  # client recourse: resubmits per lost item
    recovery_bound_s: float = 60.0
    wait_timeout_s: float = 180.0
    migrate_stuck_after_s: float = 60.0
    workdir: str = "."  # spill/ and logs/ land under here
    summary_file: str | None = None  # append the summary as one JSONL line
    # the governor drill (docs/SERVING.md "Resource governance"): arm
    # GOVERNOR_POINTS by default, run every worker with the wedge
    # watchdog at ``settle_deadline_s``, track supervisor recycles, and
    # verify the extra ``governor`` invariant (OOM masked — no worker
    # death outside the wedge-recycle/kill schedule; both points fired)
    governor: bool = False
    settle_deadline_s: float = 1.0
    # the stream drill (docs/STREAMING.md): arm STREAM_POINTS by
    # default, schedule mid-run edits on every session, hang live
    # watchers on each sid through the SIGKILL, and verify the extra
    # ``stream_continuity`` invariant — gapless seqs across failover,
    # watcher agreement, reconstruction == the replay_edit_log oracle
    stream: bool = False
    lenia_sessions: int = 1  # stream drill only: continuous-tier sids
    watchers_per_session: int = 2
    # the surge drill (docs/FLEET.md "Autoscaling" + docs/SERVING.md
    # "Tenant QoS"): a fleet with a standby pool and a live autoscaler
    # rides a ``surge_factor``x admission burst split between a
    # guaranteed and a best-effort tenant, and the drill verifies the
    # extra ``scale`` invariant (recruited to full strength through the
    # burst, released back to the base after it, both scale chaos points
    # fired) and ``qos`` invariant (every refusal typed and best-effort-
    # only, guaranteed-tenant admission p99 bounded)
    surge: bool = False
    standby: int = 2  # parked slots the autoscaler may recruit
    surge_factor: int = 10  # burst size = surge_factor x det_sessions
    qos_p99_bound_s: float = 5.0  # guaranteed-tenant submit p99 bound
    scale_wait_s: float = 90.0  # budget for the post-burst release-back


@dataclass
class WorkItem:
    """One workload trajectory and its precomputed solo oracle."""

    tag: str
    rule: str
    board: np.ndarray
    steps: int
    seed: int
    temperature: float | None
    oracle: bytes
    sid: str | None = None
    outcome: str = "pending"  # done | lost | failed | pending
    detail: str = ""
    resubmits: int = 0
    delivered: bool = False  # a DONE answer matched the oracle
    # stream drill fields: the pre-scheduled steering this session
    # carries ([[step, cells], ...]) — its oracle is then the
    # ``replay_edit_log`` of the same log — and whether the oracle
    # compare is allclose (continuous tier) rather than byte-equal
    edits: list = field(default_factory=list)
    continuous: bool = False
    # surge drill fields: which tenant this item submits as (the API key
    # carried on its requests) and which traffic phase it belongs to
    api_key: str | None = None
    phase: str = ""  # "trickle" | "burst"


def _build_stream_items(cfg: DrillConfig) -> list[WorkItem]:
    """The stream drill's workload: every session carries pre-scheduled
    mid-run edits, and its oracle is ``replay_edit_log`` of the same log
    run solo (at a DIFFERENT chunk cadence than the fleet's, so the
    compare also proves edit placement is chunk-independent)."""
    from tpu_life_torch.models.lenia import seeded_board as lenia_board
    from tpu_life_torch.serve.stream import replay_edit_log

    items: list[WorkItem] = []

    def edits_for(steps: int, value) -> list:
        zero = 0.0 if isinstance(value, float) else 0
        return [
            [max(1, steps // 3), [[1, 1, value], [2, 3, value]]],
            [max(2, (2 * steps) // 3), [[3, 4, zero], [1, 1, value]]],
        ]

    def oracle(board, rule, steps, edits, *, seed=None, temperature=None):
        return replay_edit_log(
            board, rule, steps, edits,
            seed=seed, temperature=temperature,
            chunk_steps=max(3, cfg.chunk_steps + 1),
        )

    for i in range(cfg.det_sessions):
        steps = max(
            cfg.chunk_steps * cfg.min_progress,
            cfg.steps - (cfg.steps * i) // (2 * max(cfg.det_sessions, 1)),
        )
        seed = cfg.seed * 1000 + i
        board = mc.seeded_board(cfg.size, cfg.size, 0.45, seed=seed)
        edits = edits_for(steps, 1)
        items.append(
            WorkItem(
                tag=f"det{i}",
                rule="conway",
                board=board,
                steps=steps,
                seed=seed,
                temperature=None,
                oracle=oracle(board, "conway", steps, edits).tobytes(),
                edits=edits,
            )
        )
    for i in range(cfg.ising_sessions):
        seed = cfg.seed * 1000 + 500 + i
        temp = 2.0 + 0.3 * i
        steps = max(cfg.chunk_steps * cfg.min_progress, cfg.steps // 2)
        board = mc.seeded_board(16, 16, 0.5, seed=seed)
        edits = edits_for(steps, 1)
        items.append(
            WorkItem(
                tag=f"ising{i}",
                rule="ising",
                board=board,
                steps=steps,
                seed=seed,
                temperature=temp,
                oracle=oracle(
                    board, "ising", steps, edits, seed=seed, temperature=temp
                ).tobytes(),
                edits=edits,
            )
        )
    for i in range(cfg.lenia_sessions):
        seed = cfg.seed * 1000 + 800 + i
        steps = max(cfg.chunk_steps * cfg.min_progress, cfg.steps // 3)
        board = lenia_board(32, 32, 0.4, seed=seed)
        edits = edits_for(steps, 0.75)
        items.append(
            WorkItem(
                tag=f"lenia{i}",
                rule="lenia",
                board=board,
                steps=steps,
                seed=seed,
                temperature=None,
                oracle=oracle(board, "lenia", steps, edits).tobytes(),
                edits=edits,
                continuous=True,
            )
        )
    return items


#: The surge drill's tenant API keys (seeded fixtures, not secrets).
SURGE_GOLD_KEY = "drill-gold-key"
SURGE_FREE_KEY = "drill-free-key"


def _build_surge_items(cfg: DrillConfig) -> list[WorkItem]:
    """The surge workload: a 1x trickle of guaranteed-tenant sessions,
    then a ``surge_factor``x burst split between the guaranteed and the
    best-effort tenant.  All conway with precomputed oracles — the
    standard bit_identity / no_lost_work invariants apply unchanged."""
    rule = get_rule("conway")
    items: list[WorkItem] = []

    def det_item(tag: str, i: int, key: str, phase: str) -> WorkItem:
        steps = max(
            cfg.chunk_steps * cfg.min_progress,
            cfg.steps - (cfg.steps * (i % 7)) // 14,
        )
        seed = cfg.seed * 1000 + i
        board = mc.seeded_board(cfg.size, cfg.size, 0.45, seed=seed)
        return WorkItem(
            tag=tag,
            rule="conway",
            board=board,
            steps=steps,
            seed=seed,
            temperature=None,
            oracle=run_np(board, rule, steps).tobytes(),
            api_key=key,
            phase=phase,
        )

    for i in range(cfg.det_sessions):
        items.append(det_item(f"trickle{i}", i, SURGE_GOLD_KEY, "trickle"))
    burst = cfg.surge_factor * cfg.det_sessions
    for i in range(burst):
        key = SURGE_GOLD_KEY if i % 2 == 0 else SURGE_FREE_KEY
        tenant = "gold" if i % 2 == 0 else "free"
        items.append(
            det_item(f"burst-{tenant}{i}", 100 + i, key, "burst")
        )
    return items


def _build_items(cfg: DrillConfig) -> list[WorkItem]:
    if cfg.stream:
        return _build_stream_items(cfg)
    if cfg.surge:
        return _build_surge_items(cfg)
    items: list[WorkItem] = []
    rule = get_rule("conway")
    for i in range(cfg.det_sessions):
        # staggered budgets: the same uneven mix the serve benches drive
        steps = max(cfg.chunk_steps * cfg.min_progress,
                    cfg.steps - (cfg.steps * i) // (2 * max(cfg.det_sessions, 1)))
        seed = cfg.seed * 1000 + i
        board = mc.seeded_board(cfg.size, cfg.size, 0.45, seed=seed)
        items.append(
            WorkItem(
                tag=f"det{i}",
                rule="conway",
                board=board,
                steps=steps,
                seed=seed,
                temperature=None,
                oracle=run_np(board, rule, steps).tobytes(),
            )
        )
    irule = get_rule("ising")
    for i in range(cfg.ising_sessions):
        seed = cfg.seed * 1000 + 500 + i
        temp = 2.0 + 0.3 * i
        steps = max(cfg.chunk_steps * cfg.min_progress, cfg.steps // 2)
        board = mc.seeded_board(16, 16, 0.5, seed=seed)
        oracle = MCHostRunner(board, irule, seed=seed, temperature=temp)
        oracle.advance(steps)
        items.append(
            WorkItem(
                tag=f"ising{i}",
                rule="ising",
                board=board,
                steps=steps,
                seed=seed,
                temperature=temp,
                oracle=oracle.fetch().tobytes(),
            )
        )
    return items


def _http_json(url: str, timeout: float = 10.0) -> tuple[int, dict]:
    """GET returning (status, parsed body) — errors included, so the
    drill reads full typed error envelopes (reason fields and all)."""
    try:
        with urllib.request.urlopen(
            urllib.request.Request(url), timeout=timeout
        ) as resp:
            return resp.status, _parse(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, _parse(e.read())


def _parse(raw: bytes) -> dict:
    try:
        doc = json.loads(raw or b"{}")
        return doc if isinstance(doc, dict) else {}
    except json.JSONDecodeError:
        return {}


def _oracle_match(item: WorkItem, board: np.ndarray) -> bool:
    """DONE board vs precomputed oracle: byte-equal for the discrete
    tiers; allclose at ``models.lenia.FLOAT_ATOL`` for the continuous
    tier (the masked-threshold delta tolerance, docs/STREAMING.md)."""
    if not item.continuous:
        return board.tobytes() == item.oracle
    from tpu_life_torch.models.lenia import FLOAT_ATOL

    want = np.frombuffer(item.oracle, dtype="<f4").reshape(board.shape)
    return bool(
        np.allclose(np.asarray(board, dtype=np.float32), want, atol=FLOAT_ATOL)
    )


class _Driller:
    """One drill run's state: the fleet, the client, the verdicts."""

    def __init__(self, cfg: DrillConfig):
        self.cfg = cfg
        self.items = _build_items(cfg)
        if cfg.points is not None:
            points = cfg.points
        elif cfg.governor:
            points = GOVERNOR_POINTS
        elif cfg.stream:
            points = STREAM_POINTS
        elif cfg.surge:
            points = SURGE_POINTS
        else:
            points = DEFAULT_POINTS
        self.plan = chaos.ChaosPlan(cfg.seed, points)
        self.accepted = 0  # 201s the clients received (== routed, invariant)
        self.kills: list[dict] = []
        self.recycles: list[dict] = []  # supervisor unready-recycles observed
        self.extra_invariants: list[str] = []
        self.violations: dict[str, list[str]] = {}
        self.injection_scrapes: dict[str, dict[str, float]] = {}
        self.fleet = None
        self.base_url = ""
        # surge drill evidence (populated by _surge_submit): typed
        # best-effort sheds observed, guaranteed-tenant admission
        # latencies, and any refusal the QoS contract forbids
        self.surge_sheds: list[dict] = []
        self.surge_gold_lat_s: list[float] = []
        # the same latencies keyed by phase: "trickle" is the 1x
        # baseline, "burst" the surge_factor-x spike — the pair the
        # BENCH_surge record reports as p99 at 1x vs 10x
        self.surge_gold_lat_phase: dict[str, list[float]] = {}
        self.surge_gold_refusals: list[str] = []
        self.surge_bad_refusals: list[str] = []

    # -- plumbing ----------------------------------------------------------
    def violate(self, invariant: str, detail: str) -> None:
        self.violations.setdefault(invariant, []).append(detail)
        log.error("chaos drill: %s violated: %s", invariant, detail)

    def _draw(self, label: str, n: int) -> int:
        """A seeded drill-side draw (victim choice) — same Threefry
        discipline as the plan, so the kill schedule replays too."""
        k0, k1 = key_halves(self.cfg.seed)
        # the port's Threefry is numpy's alone: no array-module argument
        u, _ = threefry2x32(
            k0, k1, np.uint32(zlib.crc32(label.encode())), np.uint32(n)
        )
        return int(u)

    def _scrape_injections(self) -> None:
        """Merge chaos_injections_total from the fleet's merged /metrics
        (fleet-process + live workers) into the running per-point view —
        best-effort evidence of which seams actually fired."""
        try:
            req = urllib.request.Request(self.base_url + "/metrics")
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                text = resp.read().decode()
        except Exception:
            return
        for line in text.splitlines():
            # chaos_injections_total: live per-process counters (the
            # fleet's own + each reachable worker's, worker-labeled).
            # fleet_chaos_injections: the supervisor's last-seen retention
            # per worker — it SURVIVES the worker's death, so the merged
            # accounting is exact rather than a pre-kill floor (the max
            # below dedups it against the live series it mirrors).
            if not (
                line.startswith("chaos_injections_total{")
                or line.startswith("fleet_chaos_injections{")
            ):
                continue
            labels, _, value = line.rpartition(" ")
            point = outcome = worker = ""
            inner = labels[labels.find("{") + 1 : labels.rfind("}")]
            for part in inner.split(","):
                k, _, v = part.partition("=")
                v = v.strip('"')
                if k == "point":
                    point = v
                elif k == "outcome":
                    outcome = v
                elif k == "worker":
                    worker = v
            if not point:
                continue
            series = self.injection_scrapes.setdefault(point, {})
            key = f"{worker or 'fleet'}:{outcome}"
            try:
                # counters reset when a worker respawns under the same
                # label: keep the max ever seen per series — a floor on
                # the true total, never an overcount of one incarnation
                series[key] = max(series.get(key, 0.0), float(value))
            except ValueError:
                continue

    def injections_by_point(self) -> dict[str, float]:
        return {
            point: sum(series.values())
            for point, series in sorted(self.injection_scrapes.items())
        }

    # -- workload ----------------------------------------------------------
    def submit_item(self, client: GatewayClient, item: WorkItem) -> bool:
        try:
            item.sid = client.submit(
                board=item.board,
                rule=item.rule,
                steps=item.steps,
                seed=item.seed,
                temperature=item.temperature,
                scheduled_edits=item.edits or None,
            )
        except Exception as e:  # noqa: BLE001 - a refused submit is data
            item.outcome = "rejected"
            item.detail = str(e)
            return False
        self.accepted += 1
        item.outcome = "pending"
        return True

    def poll_until_terminal(self, client: GatewayClient, item: WorkItem) -> None:
        """Poll one sid to a terminal observation, riding out transient
        502s (injected resets) and garbled bodies; on DONE fetch and
        byte-check the result; on typed loss record the reason."""
        deadline = time.monotonic() + self.cfg.wait_timeout_s
        url = f"{self.base_url}/v1/sessions/{item.sid}"
        while True:
            if time.monotonic() > deadline:
                item.outcome = "stuck"
                item.detail = "never reached a terminal observation"
                self.violate(
                    "all_terminal",
                    f"{item.tag} ({item.sid}) still non-terminal after "
                    f"{self.cfg.wait_timeout_s:.0f}s",
                )
                return
            try:
                status, doc = _http_json(url)
            except Exception as e:  # noqa: BLE001 - transport noise: retry
                log.debug("chaos drill: poll %s transport error %s", item.sid, e)
                time.sleep(0.1)
                continue
            if status == 200 and "finished" not in doc:
                # a chaos mid-body truncation: retry, it is transient
                time.sleep(0.05)
                continue
            if status == 200 and not doc["finished"]:
                time.sleep(0.05)
                continue
            if status == 200:
                state = doc.get("state")
                if state == "done":
                    self._check_result(item)
                else:
                    item.outcome = "failed"
                    item.detail = str(doc.get("error") or "")
                    if not item.detail:
                        self.violate(
                            "legal_410",
                            f"{item.tag} failed without an error string",
                        )
                return
            if status in (409, 502):
                # migrating / injected upstream ambiguity: both transient
                time.sleep(0.1)
                continue
            if status == 410:
                err = doc.get("error") or {}
                item.outcome = "lost"
                item.detail = str(err.get("reason") or err.get("code") or "")
                if err.get("code") == "worker_lost":
                    if err.get("reason") not in LEGAL_410_REASONS:
                        self.violate(
                            "legal_410",
                            f"{item.tag} 410 with illegal reason "
                            f"{err.get('reason')!r}",
                        )
                elif err.get("code") != "session_failed":
                    self.violate(
                        "legal_410",
                        f"{item.tag} 410 with unexpected code {err.get('code')!r}",
                    )
                return
            # anything else for an accepted sid is silent loss (404 means
            # the fleet forgot a session it admitted)
            item.outcome = "lost"
            item.detail = f"unexpected status {status}"
            self.violate(
                "legal_410", f"{item.tag} answered {status} {doc!r}"
            )
            return

    def _check_result(self, item: WorkItem) -> None:
        url = f"{self.base_url}/v1/sessions/{item.sid}/result?format=raw"
        deadline = time.monotonic() + 30.0
        while True:
            try:
                status, doc = _http_json(url)
            except Exception:  # noqa: BLE001 - transport noise: retry
                status, doc = 502, {}
            if status == 200:
                try:
                    board = protocol.decode_result(doc)
                except Exception:  # noqa: BLE001 - injected mid-body garble
                    board = None
                if board is not None:
                    item.outcome = "done"
                    if _oracle_match(item, board):
                        item.delivered = True
                    else:
                        self.violate(
                            "bit_identity",
                            f"{item.tag} ({item.sid}) differs from its "
                            f"solo oracle",
                        )
                    return
            elif status not in (409, 502):
                # DONE then no board is a contract violation, not retry noise
                self.violate(
                    "bit_identity",
                    f"{item.tag} done but result answered {status}",
                )
                item.outcome = "failed"
                item.detail = f"result {status}"
                return
            if time.monotonic() > deadline:
                self.violate(
                    "bit_identity",
                    f"{item.tag} done but its result never materialized",
                )
                item.outcome = "failed"
                item.detail = "result unavailable"
                return
            time.sleep(0.1)

    # -- the kill schedule --------------------------------------------------
    def run_kills(self, client: GatewayClient) -> None:
        sup = self.fleet.supervisor
        for k in range(self.cfg.kills):
            victim = self._wait_for_victim(client, k)
            if victim == "drained":
                # every session finished before this kill could land: not
                # an invariant violation, but the summary shows the gap
                self.kills.append({"worker": None, "skipped": "drained"})
                continue
            if victim is None:
                self.violate(
                    "recovery_bounded",
                    f"kill {k}: no worker ever owned a progressed session",
                )
                return
            self._scrape_injections()  # evidence BEFORE the worker dies
            gen0 = victim.generation
            t0 = time.monotonic()
            os.kill(victim.proc.pid, signal.SIGKILL)
            log.info("chaos drill: SIGKILL %s (kill %d)", victim.name, k)
            # recovery = kill -> the VICTIM's successor generation answers
            # ready again AND the fleet is back to full ready strength.
            # Requiring the generation bump keeps the timer honest: right
            # after the SIGKILL the supervisor may not have observed the
            # death yet, and "everything still looks ready" must not
            # count as an instant recovery.
            deadline = t0 + self.cfg.recovery_bound_s
            while not (
                victim.generation > gen0
                and len(sup.ready_workers()) >= self.cfg.workers
            ):
                if time.monotonic() > deadline:
                    self.kills.append(
                        {"worker": victim.name, "recovery_s": None}
                    )
                    self.violate(
                        "recovery_bounded",
                        f"kill {k} ({victim.name}): fleet not back to "
                        f"{self.cfg.workers} ready within "
                        f"{self.cfg.recovery_bound_s:.0f}s",
                    )
                    return
                time.sleep(0.05)
            self.kills.append(
                {"worker": victim.name, "recovery_s": time.monotonic() - t0}
            )

    def _wait_for_victim(self, client: GatewayClient, k: int):
        """A ready worker owning at least one live, progressed session —
        chosen by a seeded draw among the candidates, so the kill
        schedule replays with the seed."""
        deadline = time.monotonic() + self.cfg.wait_timeout_s
        while time.monotonic() < deadline:
            owners: dict[str, int] = {}
            in_flight = 0
            for item in self.items:
                if item.sid is None or item.outcome != "pending":
                    continue
                try:
                    status, doc = _http_json(
                        f"{self.base_url}/v1/sessions/{item.sid}", timeout=5.0
                    )
                except Exception:  # noqa: BLE001
                    continue
                if status != 200 or doc.get("finished") is not False:
                    continue
                in_flight += 1
                worker = doc.get("worker")
                done = doc.get("steps_done", 0)
                if worker and done >= self.cfg.min_progress:
                    owners[worker] = owners.get(worker, 0) + 1
            if in_flight == 0:
                # every accepted session already finished: budgets were
                # too short for this kill — nothing left worth killing
                return "drained"
            ready = {w.name: w for w in self.fleet.supervisor.ready_workers()}
            candidates = sorted(n for n in owners if n in ready)
            if candidates:
                pick = self._draw("drill.kill", k) % len(candidates)
                return ready[candidates[pick]]
            time.sleep(0.1)
        return None

    # -- invariants ----------------------------------------------------------
    def check_metrics(self) -> None:
        stats = self.fleet.stats()
        routed = sum(stats.get("routed", {}).values())
        if routed != self.accepted:
            self.violate(
                "metrics_consistent",
                f"fleet_routed_total {routed} != accepted 201s {self.accepted}",
            )
        outcomes = {i.outcome for i in self.items}
        if "pending" in outcomes:
            self.violate(
                "metrics_consistent", "an item finished the drill still pending"
            )
        mig = stats.get("migrations", {})
        lost_410 = sum(1 for i in self.items if i.outcome == "lost")
        covered = sum(mig.values()) if mig else 0
        if lost_410 and not mig:
            self.violate(
                "metrics_consistent",
                f"{lost_410} typed losses but no migration accounting at all",
            )
        self._migration_summary = {"migrations": mig, "covered": covered}

    def verdicts(self) -> dict[str, dict]:
        out = {}
        names = (
            "all_terminal",
            "bit_identity",
            "legal_410",
            "no_lost_work",
            "recovery_bounded",
            "metrics_consistent",
            *self.extra_invariants,
        )
        for name in names:
            probs = self.violations.get(name, [])
            out[name] = {"ok": not probs, "violations": probs}
        return out


def _check_governor(d: "_Driller", fleet) -> None:
    """The governor invariant (docs/SERVING.md "Resource governance"),
    appended to the standard six when ``--governor`` is armed:

    - both governor points actually fired (a drill that never reached
      its seams must not certify anything);
    - every worker restart is accounted for by a wedge-recycle or a
      drill-driven SIGKILL — i.e. an OOM (or any other masked fault)
      never killed a worker.  Sessions' byte-identity and delivery are
      already covered by bit_identity / no_lost_work.
    """
    d.extra_invariants.append("governor")
    inj = d.injections_by_point()
    ooms = inj.get("engine.oom", 0)
    wedges = inj.get("engine.wedge", 0)
    if ooms < 1:
        d.violate(
            "governor",
            f"engine.oom never fired (injections: {inj}) — the OOM "
            f"masking path was not exercised; pick a seed that reaches it",
        )
    if wedges < 1:
        d.violate(
            "governor",
            f"engine.wedge never fired (injections: {inj}) — the wedge "
            f"watchdog path was not exercised; pick a seed that reaches it",
        )
    restarts = fleet.supervisor.restarts()
    sigkills = sum(1 for k in d.kills if k.get("worker"))
    allowed = wedges + sigkills
    if restarts > allowed:
        d.violate(
            "governor",
            f"{restarts:g} worker restart(s) but only {allowed:g} are "
            f"accounted for ({wedges:g} wedge fire(s) + {sigkills} "
            f"SIGKILL(s)) — a fault the governor must MASK killed a worker",
        )


class _StreamWatcher:
    """One live watcher of one fleet sid: a thread consuming the
    router's ndjson delta stream through the standard client,
    reconnecting at its cursor on tears (the documented watcher
    recourse) and folding every frame through ``apply_frame`` — so the
    drill can assert gapless seqs across the SIGKILL and compare the
    reconstruction against the ``replay_edit_log`` oracle."""

    def __init__(self, base_url: str, item: WorkItem, tag: str):
        import threading

        self.base_url = base_url
        self.item = item
        self.fsid = item.sid
        self.tag = tag
        self.frames: list[dict] = []
        self.board = None  # the running apply_frame reconstruction
        self.recon_error = ""  # first StreamProtocolError, if any
        self.error = ""
        self._t = threading.Thread(
            target=self._run, name=f"drill-watch-{tag}", daemon=True
        )

    def start(self) -> None:
        self._t.start()

    def join(self, timeout: float) -> None:
        self._t.join(timeout)

    @property
    def alive(self) -> bool:
        return self._t.is_alive()

    def _run(self) -> None:
        from tpu_life_torch.serve.stream import StreamProtocolError, apply_frame

        client = GatewayClient(self.base_url, retries=4)
        cursor = 0
        attempts = 0
        while attempts <= 20:
            try:
                for frame in client.stream(self.fsid, cursor=cursor):
                    self.frames.append(frame)
                    seq = frame.get("seq")
                    if isinstance(seq, int):
                        cursor = seq + 1
                    try:
                        self.board = apply_frame(self.board, frame)
                    except StreamProtocolError as e:
                        if not self.recon_error:
                            self.recon_error = str(e)
                    if frame.get("type") in ("end", "shed"):
                        return
                # closed without a terminal frame: reconnect at cursor
                attempts += 1
            except Exception as e:  # noqa: BLE001 - transport tear: retry
                attempts += 1
                self.error = str(e)
                time.sleep(0.2)
        if not self.error:
            self.error = "reconnect budget exhausted without an end frame"


def _check_stream(d: "_Driller", watchers: list[_StreamWatcher]) -> None:
    """The stream invariant (docs/STREAMING.md), appended to the
    standard six when ``--stream`` is armed:

    - both stream points actually fired (torn upstream + stalled
      watcher write — the seams this drill exists to exercise);
    - every watcher terminated on a typed ``end`` with state ``done``
      (no hang, no shed, no synthetic ``lost``) and its sequence
      numbers are strictly consecutive ACROSS the mid-stream SIGKILL;
    - watchers of the same sid agree byte-for-byte on every shared seq
      (the fan-out broadcast is one stream, not N reconciliations);
    - each watcher's folded reconstruction equals the session's
      ``replay_edit_log`` oracle — byte-equal for the discrete tiers,
      allclose at ``FLOAT_ATOL`` for lenia — so bit-reproducibility
      under steering is machine-verified end to end.
    """
    d.extra_invariants.append("stream_continuity")
    inj = d.injections_by_point()
    local = {p: sum(c.values()) for p, c in chaos.counts().items()}
    for point in ("stream.reset", "watch.slow_reader"):
        if inj.get(point, 0) + local.get(point, 0) < 1:
            d.violate(
                "stream_continuity",
                f"{point} never fired (injections: {inj}) — the seam was "
                f"not exercised; pick a seed that reaches it",
            )
    for w in watchers:
        if w.alive:
            d.violate("stream_continuity", f"{w.tag} never terminated")
            continue
        if w.error:
            d.violate("stream_continuity", f"{w.tag}: {w.error}")
        seqs = [
            f["seq"] for f in w.frames if isinstance(f.get("seq"), int)
        ]
        for a, b in zip(seqs, seqs[1:]):
            if b != a + 1:
                d.violate(
                    "stream_continuity",
                    f"{w.tag} seq gap: {a} -> {b} (gapless-across-failover "
                    f"broken)",
                )
                break
        if w.item.resubmits:
            # the session was typed-lost and resubmitted under a fresh
            # sid: this watcher's ORIGINAL stream legitimately ended
            # early, so terminal-state/reconstruction checks don't apply
            continue
        last = w.frames[-1] if w.frames else {}
        if last.get("type") != "end" or last.get("state") != "done":
            d.violate(
                "stream_continuity",
                f"{w.tag} ended {last.get('type')!r}/{last.get('state')!r}, "
                f"expected end/done",
            )
            continue
        if w.recon_error:
            d.violate(
                "stream_continuity", f"{w.tag} reconstruction: {w.recon_error}"
            )
        elif w.board is None or not _oracle_match(w.item, w.board):
            d.violate(
                "stream_continuity",
                f"{w.tag} reconstruction differs from the replay_edit_log "
                f"oracle",
            )
    by_sid: dict[str, list[_StreamWatcher]] = {}
    for w in watchers:
        by_sid.setdefault(w.fsid, []).append(w)
    for fsid, ws in by_sid.items():
        maps = [
            {f["seq"]: f for f in w.frames if isinstance(f.get("seq"), int)}
            for w in ws
        ]
        shared = set(maps[0])
        for m in maps[1:]:
            shared &= set(m)
        for s in sorted(shared):
            if any(m[s] != maps[0][s] for m in maps[1:]):
                d.violate(
                    "stream_continuity",
                    f"watchers of {fsid} disagree at seq {s} — the "
                    f"broadcast is not byte-identical",
                )
                break


def _write_surge_policy(workdir: str) -> str:
    """The surge drill's tenant fixture (docs/SERVING.md "Tenant QoS"):
    a guaranteed ``gold`` tenant at 4x the weight of a best-effort
    ``free`` tenant, with the soft shed rung pulled LOW so the burst
    exercises best-effort shedding long before any hard limit — the
    ladder the qos invariant verifies (free sheds typed, gold never
    feels the wave)."""
    policy = {
        "tenants": [
            {
                "name": "gold",
                "tier": "guaranteed",
                "weight": 4,
                "api_keys": [SURGE_GOLD_KEY],
            },
            {
                "name": "free",
                "tier": "best_effort",
                "weight": 1,
                "api_keys": [SURGE_FREE_KEY],
            },
        ],
        "best_effort_water": 0.03,
    }
    path = os.path.join(workdir, "qos.json")
    with open(path, "w") as f:
        json.dump(policy, f)
    return path


def _surge_submit(d: "_Driller") -> None:
    """Drive the surge workload AS its tenants: raw (retries=0) clients
    so every refusal surfaces typed instead of being absorbed by client
    backoff.  Gold submits are single-attempt with admission latency
    recorded (the p99 the qos invariant bounds); free submits ride the
    documented shed recourse — honor Retry-After, resubmit — until
    admitted or the wait budget runs out."""
    from tpu_life_torch.gateway.client import GatewayError

    cfg = d.cfg
    raw = {
        key: GatewayClient(d.base_url, api_key=key, retries=0)
        for key in (SURGE_GOLD_KEY, SURGE_FREE_KEY)
    }

    def attempt(item: WorkItem) -> str:
        gold = item.api_key == SURGE_GOLD_KEY
        t0 = time.monotonic()
        try:
            item.sid = raw[item.api_key].submit(
                board=item.board,
                rule=item.rule,
                steps=item.steps,
                seed=item.seed,
                temperature=item.temperature,
            )
        except GatewayError as e:
            if not gold and e.status == 503 and e.code == "shed_best_effort":
                d.surge_sheds.append(
                    {
                        "tag": item.tag,
                        "code": e.code,
                        "retry_after": e.retry_after,
                    }
                )
                return "shed"
            refusal = f"{item.tag}: {e.status} {e.code}"
            (d.surge_gold_refusals if gold else d.surge_bad_refusals).append(
                refusal
            )
            item.outcome = "rejected"
            item.detail = refusal
            return "refused"
        except Exception as e:  # noqa: BLE001 - raw client: no retries,
            # so transport noise at submit is indistinguishable from an
            # untyped refusal — record it as one (the qos invariant's
            # "every refusal is typed" is exactly this strict)
            refusal = f"{item.tag}: {e}"
            (d.surge_gold_refusals if gold else d.surge_bad_refusals).append(
                refusal
            )
            item.outcome = "rejected"
            item.detail = refusal
            return "refused"
        if gold:
            lat = time.monotonic() - t0
            d.surge_gold_lat_s.append(lat)
            d.surge_gold_lat_phase.setdefault(item.phase, []).append(lat)
        d.accepted += 1
        item.outcome = "pending"
        return "ok"

    for item in d.items:
        if item.phase == "trickle":
            attempt(item)
    time.sleep(1.5)  # let the control loop see the 1x baseline first
    retry: list[WorkItem] = []
    for item in d.items:
        if item.phase == "burst" and attempt(item) == "shed":
            retry.append(item)
    deadline = time.monotonic() + cfg.wait_timeout_s
    while retry and time.monotonic() < deadline:
        # the documented best-effort recourse: sleep the advertised
        # Retry-After (bounded — this is a drill, not a backoff study)
        pause = 0.3
        hints = [
            s["retry_after"] for s in d.surge_sheds if s.get("retry_after")
        ]
        if hints:
            pause = min(1.0, max(0.1, float(hints[-1])))
        time.sleep(pause)
        retry = [item for item in retry if attempt(item) == "shed"]
    for item in retry:
        item.outcome = "rejected"
        item.detail = "shed_best_effort past the retry deadline"


class _ScaleWatch:
    """Background sampler of the supervisor's (active, standby) split:
    records every transition with its wall-clock offset plus the peak
    active strength — the scale invariant's evidence that the fleet
    actually recruited through the burst and released after it."""

    def __init__(self, supervisor):
        import threading

        self.sup = supervisor
        self.transitions: list[dict] = []
        self.peak_active = 0
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        self._t = threading.Thread(
            target=self._run, name="drill-scale-watch", daemon=True
        )

    def start(self) -> None:
        self._t0 = time.monotonic()
        self._t.start()

    def stop(self) -> None:
        self._stop.set()
        self._t.join(timeout=5)

    def _run(self) -> None:
        last = None
        while not self._stop.wait(0.05):
            try:
                active, standby = self.sup.scale_counts()
            except Exception:  # noqa: BLE001 - sampling must not die
                continue
            self.peak_active = max(self.peak_active, active)
            if (active, standby) != last:
                last = (active, standby)
                self.transitions.append(
                    {
                        "t_s": round(time.monotonic() - self._t0, 3),
                        "active": active,
                        "standby": standby,
                    }
                )


def _p99(xs: list) -> float | None:
    if not xs:
        return None
    s = sorted(xs)
    return float(s[min(len(s) - 1, int(0.99 * len(s)))])


def _check_scale(
    d: "_Driller", fleet, watch: _ScaleWatch, released_back_s
) -> None:
    """The scale invariant (docs/FLEET.md "Autoscaling"), appended when
    ``--surge`` is armed:

    - the burst recruited the fleet to FULL strength (base + every
      standby slot) — a surge the loop slept through certifies nothing;
    - after the burst drained, the loop released back DOWN to the base
      strength within ``scale_wait_s`` (hysteresis + idle grace +
      cooldowns included);
    - both scale chaos points actually fired: one recruit was refused
      at the seam (and the loop still reached full strength — no armed
      cooldown after a failed recruit) and one release was steered onto
      the busiest worker (and no session was lost — covered by the
      standard invariants riding along).
    """
    d.extra_invariants.append("scale")
    full = d.cfg.workers + d.cfg.standby
    if watch.peak_active < full:
        d.violate(
            "scale",
            f"peak active strength {watch.peak_active} never reached "
            f"{full} (base {d.cfg.workers} + {d.cfg.standby} standby) — "
            f"the burst did not recruit the pool",
        )
    if released_back_s is None:
        active, standby = fleet.supervisor.scale_counts()
        d.violate(
            "scale",
            f"fleet still at {active} active / {standby} standby "
            f"{d.cfg.scale_wait_s:.0f}s after the burst drained — "
            f"never released back to base {d.cfg.workers}",
        )
    inj = d.injections_by_point()
    local = {p: sum(c.values()) for p, c in chaos.counts().items()}
    for point in ("scale.recruit.fail", "scale.release.race"):
        if inj.get(point, 0) + local.get(point, 0) < 1:
            d.violate(
                "scale",
                f"{point} never fired (injections: {inj}) — the seam "
                f"was not exercised; pick a seed that reaches it",
            )


def _check_qos(d: "_Driller") -> None:
    """The qos invariant (docs/SERVING.md "Tenant QoS"), appended when
    ``--surge`` is armed:

    - the burst actually reached the shed ladder (at least one typed
      best-effort shed, each carrying Retry-After);
    - every refusal the drill saw was TYPED ``shed_best_effort`` and
      landed on the best-effort tenant ONLY — the guaranteed tenant was
      never refused, never shed, never rate-limited;
    - guaranteed-tenant admission latency p99 stayed under
      ``qos_p99_bound_s`` THROUGH the burst — isolation, not just
      eventual admission.
    """
    d.extra_invariants.append("qos")
    if not d.surge_sheds:
        d.violate(
            "qos",
            "no best-effort shed ever fired — the burst never reached "
            "the shed ladder; raise --surge-factor",
        )
    for shed in d.surge_sheds:
        if not shed.get("retry_after"):
            d.violate(
                "qos",
                f"{shed['tag']}: shed_best_effort without a Retry-After "
                f"hint — the documented recourse is unplayable",
            )
            break
    for refusal in d.surge_gold_refusals:
        d.violate("qos", f"guaranteed tenant refused: {refusal}")
    for refusal in d.surge_bad_refusals:
        d.violate("qos", f"untyped or mis-tiered refusal: {refusal}")
    p99 = _p99(d.surge_gold_lat_s)
    if p99 is not None and p99 > d.cfg.qos_p99_bound_s:
        d.violate(
            "qos",
            f"guaranteed-tenant admission p99 {p99:.3f}s exceeds the "
            f"{d.cfg.qos_p99_bound_s:.1f}s bound — the burst leaked into "
            f"the guaranteed tier",
        )


class _RecycleWatch:
    """Background sampler of supervisor state: records every observed
    unready-recycle — a worker leaving READY and coming back under a
    BUMPED generation — with its wall-clock recovery time.  The governor
    drill's wedge evidence: the watchdog flipped readyz, the supervisor
    recycled, and how long the round trip took."""

    def __init__(self, supervisor, on_down=None):
        import threading

        self.sup = supervisor
        self.recycles: list[dict] = []
        # fired ONCE, on the first ready->down transition observed: the
        # governor drill disarms the wedge point in the inherited env
        # spec here, so RESPAWNED workers come up clean — without it
        # every fresh generation draws a fresh per-process schedule and
        # the wedge refires forever (an unbounded recycle storm instead
        # of one rescued wedge)
        self.on_down = on_down
        self._down_seen = False
        self._stop = threading.Event()
        self._t = threading.Thread(
            target=self._run, name="drill-recycle-watch", daemon=True
        )

    def start(self):
        self._t.start()

    def stop(self):
        self._stop.set()
        self._t.join(timeout=5)

    def _run(self):
        ready_gen: dict[str, int] = {}  # last generation observed READY
        down: dict[str, tuple[float, int]] = {}  # name -> (since, gen then)
        while not self._stop.wait(0.05):
            try:
                states = self.sup.states()
                gens = {w.name: w.generation for w in self.sup.workers}
            except Exception:  # noqa: BLE001 - sampling must not die
                continue
            now = time.monotonic()
            for name, state in states.items():
                gen = gens.get(name, 0)
                if state == "ready":
                    if name in down:
                        since, gen0 = down.pop(name)
                        if gen > gen0:  # came back as a NEW incarnation
                            self.recycles.append(
                                {
                                    "worker": name,
                                    "generation": gen,
                                    "recovery_s": now - since,
                                }
                            )
                    ready_gen[name] = gen
                elif name in ready_gen and name not in down:
                    down[name] = (now, ready_gen[name])
                    if not self._down_seen:
                        self._down_seen = True
                        if self.on_down is not None:
                            try:
                                self.on_down()
                            except Exception:  # noqa: BLE001
                                log.exception("drill: on_down hook failed")


def run_drill(cfg: DrillConfig) -> dict:
    """Run one seeded chaos drill; returns the summary record (also
    appended to ``cfg.summary_file`` when set).  ``summary["ok"]`` is the
    single pass/fail verdict; on failure the summary names the seed and
    plan digest that replay the run verbatim."""
    from tpu_life_torch.fleet import Fleet, FleetConfig

    d = _Driller(cfg)
    spec = d.plan.spec()
    t_start = time.monotonic()
    prev_env = os.environ.get(chaos.ENV_VAR)
    os.environ[chaos.ENV_VAR] = json.dumps(spec)  # workers inherit this
    chaos.arm(d.plan)  # this process: router/supervisor/migrator seams
    workdir = cfg.workdir
    max_queue = 4 * (cfg.det_sessions + cfg.ising_sessions)
    if cfg.surge:
        # headroom above the WHOLE burst: the drill's shed ladder must
        # be exercised by the soft best-effort rung, never by hard
        # queue_full — a gold refusal at the hard rung is a qos failure
        max_queue = 4 * len(d.items)
    worker_args = [
        "--serve-backend", cfg.backend,
        "--capacity", str(cfg.capacity),
        "--chunk-steps", str(cfg.chunk_steps),
        "--max-queue", str(max_queue),
    ]
    if cfg.device is not None:
        worker_args += ["--device", cfg.device]
    if cfg.governor:
        # every worker runs the wedge watchdog: a wedged settle flips its
        # /readyz to 500 engine_wedged, and the supervisor's existing
        # unready-recycle + migration path is what the drill verifies
        worker_args += ["--settle-deadline", str(cfg.settle_deadline_s)]
    autoscale = None
    if cfg.surge:
        from tpu_life_torch.fleet.autoscaler import AutoscaleConfig

        # drill-speed control loop: tight windows and cooldowns so the
        # whole recruit->release arc fits in CI seconds, burn-driven
        # scaling OFF (the drill's own sheds light the burn windows for
        # minutes — wall-clock the release-back must not wait on), and
        # the ceiling at exactly base + pool so "full strength" is a
        # deterministic number the scale invariant can assert
        autoscale = AutoscaleConfig(
            min_workers=cfg.workers,
            max_workers=cfg.workers + cfg.standby,
            depth_high=3.0,
            depth_low=0.5,
            window_s=5.0,
            cooldown_up_s=0.5,
            cooldown_down_s=2.0,
            idle_grace_s=1.5,
            scale_on_burn=False,
        )
        worker_args += [
            "--qos", _write_surge_policy(workdir),
            "--series-every", "0.25",
        ]
    fleet = Fleet(
        FleetConfig(
            workers=cfg.workers,
            port=0,
            worker_args=tuple(worker_args),
            log_dir=os.path.join(workdir, "logs"),
            spill_dir=os.path.join(workdir, "spill"),
            spill_every=cfg.spill_every,
            probe_interval_s=0.1,
            backoff_base_s=0.2,
            migrate_stuck_after_s=cfg.migrate_stuck_after_s,
            standby=cfg.standby if cfg.surge else 0,
            autoscale=autoscale,
            series_every_s=0.25 if cfg.surge else 1.0,
        )
    )
    d.fleet = fleet

    def _disarm_wedge_for_respawns() -> None:
        # the wedge did its damage (a worker just left READY): strip
        # engine.wedge from the INHERITED spec so respawned generations
        # come up clean — each fresh process draws a fresh per-process
        # schedule, and without this the wedge refires every generation
        # (an unbounded recycle storm, not one rescued wedge).  The live
        # processes' plans are untouched; only future spawns change.
        healed = {
            k: v
            for k, v in spec.get("points", {}).items()
            if k != "engine.wedge"
        }
        os.environ[chaos.ENV_VAR] = json.dumps(
            {"seed": spec["seed"], "points": healed}
        )
        log.info("chaos drill: engine.wedge disarmed for respawns")

    watch = (
        _RecycleWatch(fleet.supervisor, on_down=_disarm_wedge_for_respawns)
        if cfg.governor
        else None
    )
    scale_watch: _ScaleWatch | None = None
    released_back_s = None
    scale_summary: dict = {}
    try:
        fleet.start()
        if not fleet.wait_ready(timeout=120, min_workers=cfg.workers):
            raise RuntimeError(
                f"fleet never became ready: {fleet.supervisor.states()}"
            )
        if watch is not None:
            watch.start()
        d.base_url = f"http://127.0.0.1:{fleet.port}"
        client = GatewayClient(d.base_url, retries=8)
        if cfg.surge:
            scale_watch = _ScaleWatch(fleet.supervisor)
            scale_watch.start()
            _surge_submit(d)
        else:
            for item in d.items:
                d.submit_item(client, item)
        watchers: list[_StreamWatcher] = []
        if cfg.stream:
            # hang N live watchers on every accepted sid BEFORE the
            # kill lands: the whole point is that they ride through it
            for item in d.items:
                if item.sid is None:
                    continue
                for w in range(cfg.watchers_per_session):
                    watchers.append(
                        _StreamWatcher(d.base_url, item, f"{item.tag}.w{w}")
                    )
            for w in watchers:
                w.start()
        if not cfg.surge:
            # the surge drill's faults are the SCALE seams (a refused
            # recruit, a raced release) — its workers stay up; SIGKILLs
            # belong to the other drills
            d.run_kills(client)
        # poll everything to terminal; play the documented client
        # recourse for typed losses (resubmit from scratch, fresh sid)
        surge_clients = (
            {
                key: GatewayClient(d.base_url, api_key=key, retries=8)
                for key in (SURGE_GOLD_KEY, SURGE_FREE_KEY)
            }
            if cfg.surge
            else {}
        )
        for item in d.items:
            if item.sid is None:
                continue
            d.poll_until_terminal(client, item)
            while (
                item.outcome in ("lost", "failed")
                and item.resubmits < cfg.resubmit_lost
            ):
                item.resubmits += 1
                # resubmits stay IN tenant: a surge item re-enters as
                # the tenant it belongs to, never as the default
                sub = surge_clients.get(item.api_key, client)
                if not d.submit_item(sub, item):
                    break
                d.poll_until_terminal(client, item)
        for item in d.items:
            # EVERY workload item must deliver — including one whose
            # submission was rejected outright (sid None): a drill that
            # dropped work at admission must not certify itself ok
            if not item.delivered:
                d.violate(
                    "no_lost_work",
                    f"{item.tag} never yielded its oracle board "
                    f"(final: {item.outcome} {item.detail})",
                )
        if cfg.stream:
            join_deadline = time.monotonic() + cfg.wait_timeout_s
            for w in watchers:
                w.join(max(0.1, join_deadline - time.monotonic()))
        d._scrape_injections()
        d.check_metrics()
        if cfg.governor:
            d.recycles = list(watch.recycles)
            _check_governor(d, fleet)
        if cfg.stream:
            _check_stream(d, watchers)
        if cfg.surge:
            # the down leg: with every session terminal the demand is
            # gone — the loop must ride hysteresis + idle grace +
            # cooldowns back DOWN to base strength on its own
            rb0 = time.monotonic()
            while time.monotonic() < rb0 + cfg.scale_wait_s:
                active, _standby = fleet.supervisor.scale_counts()
                if active <= cfg.workers:
                    released_back_s = time.monotonic() - rb0
                    break
                time.sleep(0.1)
            scale_watch.stop()
            d._scrape_injections()  # the release leg's chaos evidence
            _check_scale(d, fleet, scale_watch, released_back_s)
            _check_qos(d)
            auto = fleet.supervisor.autoscaler
            scale_summary = {
                "base": cfg.workers,
                "standby_slots": cfg.standby,
                "peak_active": scale_watch.peak_active,
                "released_back_s": released_back_s,
                "transitions": scale_watch.transitions,
                "decisions": auto.decisions if auto is not None else 0,
            }
    finally:
        if watch is not None:
            watch.stop()
        if scale_watch is not None:
            scale_watch.stop()
        try:
            fleet.begin_drain()
            fleet.wait(timeout=60)
        finally:
            fleet.close()
            chaos.disarm()
            if prev_env is None:
                os.environ.pop(chaos.ENV_VAR, None)
            else:
                os.environ[chaos.ENV_VAR] = prev_env
    elapsed = time.monotonic() - t_start
    verdicts = d.verdicts()
    outcomes: dict[str, int] = {}
    for item in d.items:
        outcomes[item.outcome] = outcomes.get(item.outcome, 0) + 1
    recoveries = [
        k["recovery_s"] for k in d.kills if k.get("recovery_s") is not None
    ]
    done = outcomes.get("done", 0)
    if cfg.governor:
        kind = "governor_drill"
    elif cfg.stream:
        kind = "stream_drill"
    elif cfg.surge:
        kind = "surge_drill"
    else:
        kind = "chaos_drill"
    summary = {
        "kind": kind,
        # the replay stamp (docs/CHAOS.md): seed + canonical plan + its
        # digest — a failed CI drill is rerun locally from exactly these
        "seed": cfg.seed,
        "plan": spec,
        "plan_digest": d.plan.digest(),
        "workers": cfg.workers,
        "kills": d.kills,
        # governor mode: the wedge-recycle evidence (worker, successor
        # generation, readyz-500 -> ready-again wall seconds)
        **({"recycles": d.recycles} if cfg.governor else {}),
        # stream mode: the fan-out evidence — watcher count, total
        # frames observed, and how many watchers ended on a clean done
        **(
            {
                "stream": {
                    "watchers": len(watchers),
                    "frames_total": sum(len(w.frames) for w in watchers),
                    "ended_done": sum(
                        1
                        for w in watchers
                        if w.frames
                        and w.frames[-1].get("type") == "end"
                        and w.frames[-1].get("state") == "done"
                    ),
                }
            }
            if cfg.stream
            else {}
        ),
        # surge mode: the recruit->release arc and the tenant-isolation
        # evidence the scale/qos invariants judged
        **(
            {
                "scale": scale_summary,
                "qos": {
                    "sheds": len(d.surge_sheds),
                    "gold_submits": len(d.surge_gold_lat_s),
                    "gold_p99_s": _p99(d.surge_gold_lat_s),
                    "gold_p99_trickle_s": _p99(
                        d.surge_gold_lat_phase.get("trickle", [])
                    ),
                    "gold_p99_burst_s": _p99(
                        d.surge_gold_lat_phase.get("burst", [])
                    ),
                    "gold_refusals": d.surge_gold_refusals,
                    "bad_refusals": d.surge_bad_refusals,
                },
            }
            if cfg.surge
            else {}
        ),
        "sessions": len(d.items),
        "accepted": d.accepted,
        "outcomes": outcomes,
        "resubmits": sum(i.resubmits for i in d.items),
        "delivered": sum(1 for i in d.items if i.delivered),
        "injections": d.injections_by_point(),
        "injections_local": chaos.counts(),
        "migrations": getattr(d, "_migration_summary", {}).get("migrations", {}),
        "invariants": verdicts,
        "ok": all(v["ok"] for v in verdicts.values()),
        "recovery_s_max": max(recoveries) if recoveries else None,
        "elapsed_s": elapsed,
        "sessions_per_sec": done / elapsed if elapsed > 0 else 0.0,
    }
    if cfg.summary_file:
        from tpu_life_torch import obs

        obs.ensure_parent(cfg.summary_file)
        with open(cfg.summary_file, "a") as f:
            f.write(json.dumps(summary) + "\n")
    return summary
