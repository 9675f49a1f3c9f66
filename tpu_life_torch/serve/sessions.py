"""Session lifecycle: one tenant's simulation request from birth to result.

The reference runs one board per process invocation; here a *session* is
the unit of multi-tenancy — (board, rule, step budget) plus lifecycle
state.  The state machine is small and strictly forward::

    QUEUED ──> RUNNING ──> DONE
       │          │ └────> FAILED     (per-slot failure / deadline eviction)
       │          └──────> CANCELLED  (cancel mid-run frees the slot)
       ├────────> FAILED              (deadline expired while queued)
       └────────> CANCELLED           (cancel before admission)

Terminal states keep either a result board (DONE) or an error string
(FAILED / CANCELLED) — never both.  ``steps_done`` advances in host-sync
chunk increments, the serving analogue of the driver's chunked epoch loop
(``backends.base.drive_runner``).
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field

import numpy as np

from tpu_life_torch.models.rules import Rule
from tpu_life_torch.serve.errors import SessionFailed, UnknownSession


class SessionState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"


#: States from which a session can never move again.
TERMINAL = frozenset(
    {SessionState.DONE, SessionState.FAILED, SessionState.CANCELLED}
)


@dataclass
class Session:
    sid: str
    board: np.ndarray  # input board (int8, owned copy)
    rule: Rule
    steps: int  # total step budget
    state: SessionState = SessionState.QUEUED
    steps_done: int = 0
    result: np.ndarray | None = None
    error: str | None = None
    submitted_at: float = 0.0
    admitted_at: float | None = None  # when the scheduler gave it a slot
    deadline: float | None = None  # absolute clock time; None = no timeout
    # fault-injection drill (mirrors RunConfig.fault_at): raise a simulated
    # per-slot device failure when the session would cross this step — the
    # fixture behind the "one bad tenant must not kill the batch" tests
    fault_at: int = 0
    slot: int | None = None  # batch slot while RUNNING
    # stochastic-tier state (tpu_life_torch.mc): the PRNG seed the trajectory is
    # replayable from, and the ising temperature (None elsewhere).  Seed is
    # also stamped for seeded-board deterministic sessions so the summary
    # is a full replay record.
    seed: int | None = None
    temperature: float | None = None
    # the execution-path stamp (docs/OBSERVABILITY.md): set at admission
    # from the engine that took the session — True on the bitplane-packed
    # stochastic engines (lanes = spins per uint32 word), False on the
    # int8 roll engines, None for deterministic engines (their packing is
    # a backend knob below the serve layer)
    packed: bool | None = None
    lanes: int | None = None
    # failover resume (docs/FLEET.md): absolute steps already completed by
    # a previous life of this trajectory before this service admitted it.
    # ``steps`` stays the REMAINING budget this service must run; views
    # report absolute progress (start_step + …) so a migrated session's
    # client sees monotone progress across the worker boundary, and the
    # MC engines re-enter the counter-based stream at the exact position.
    start_step: int = 0
    # disk-full graceful degradation (docs/CHAOS.md): set when a spill
    # write for this session failed.  The session keeps running but
    # leaves the spill plan — durability is off for it alone; a worker
    # death after this answers 410 ``spill_disabled``.
    spill_disabled: bool = False
    # spill-on-adopt (docs/FLEET.md): a resumed session (start_step > 0 —
    # it is carrying another worker's rescued trajectory) spills on the
    # FIRST spill-capable round rather than waiting out the cadence, so a
    # back-to-back kill degrades to one extra rescue instead of a 410
    # ``never_snapshotted``.  Cleared after its first successful spill.
    spill_urgent: bool = False
    # the OOM fallback ladder's stamp (docs/SERVING.md "Resource
    # governance"): set when this session's CompileKey was degraded to
    # keep serving through device OOM — ``oom_halved_chunk`` (smaller
    # compiled scan) or ``oom_host_demoted`` (the bit-identical host
    # executor).  Results stay byte-identical; only throughput degrades.
    degraded_reason: str | None = None
    # distributed-trace context (docs/OBSERVABILITY.md "Distributed
    # tracing"): the id naming this session's whole cross-process
    # journey — minted by the router (or gateway) per submitted session,
    # persisted in the spill manifest, and CARRIED ACROSS migration so a
    # resumed session continues the same trace on its survivor.  None
    # for library callers that never asked for one.
    trace_id: str | None = None
    # mid-run steering (docs/STREAMING.md "Edits"): ``pending_edits``
    # holds validated-but-unapplied cell lists from PATCH verbs, drained
    # at the next round boundary through the freeze-mask seam;
    # ``edits`` is the applied log — [(absolute_step, [(r, c, v), ...])]
    # in application order — that spills with the manifest so the
    # bit-reproducibility contract extends to steered sessions (session
    # bytes == a solo run replaying this log); ``scheduled_edits`` is a
    # resumed session's future portion of a prior life's log, re-applied
    # at exactly the recorded steps during re-execution.
    pending_edits: list = field(default_factory=list)
    edits: list = field(default_factory=list)
    scheduled_edits: list = field(default_factory=list)
    # the stream sequence floor: frames a previous life of this session
    # already produced (from the spill manifest), so the survivor's hub
    # continues the same gapless sequence space
    stream_seq: int = 0
    # tenant identity (docs/SERVING.md "Tenant QoS"): the resolved
    # tenant name this session was admitted under — set by the gateway
    # from X-API-Key through the QosPolicy, None for library callers
    # and policy-less deployments.  Rides submit -> router -> worker as
    # a typed field: quota checks, DRR fairness, and the per-tenant
    # observability rows all key on it.
    tenant: str | None = None
    # mega-board tier (docs/SERVING.md "Mega-board sessions"): the mesh
    # slice shape ``(rows, cols)`` this session's board is sharded over,
    # None for single-chip sessions.  Set at submit when the governor's
    # never-fits verdict is converted into a mesh placement; the keyer
    # mints a ``mesh:RxC`` CompileKey from it.
    mesh: tuple[int, int] | None = None
    # shard-wise resume (arXiv 2112.01075): a rectangular block loader
    # ``load_block(r0, r1, c0, c1) -> cells`` over a spilled tile set,
    # consumed once at admission by ``MeshEngine.load_tiles`` — the
    # session re-gathers shard by shard (possibly onto a different mesh
    # shape) and ``board`` stays a placeholder, so the full board is
    # never materialized on this host.  Process-local, never serialized.
    mesh_resume: object | None = None

    @property
    def steps_remaining(self) -> int:
        return max(0, self.steps - self.steps_done)

    def finish(self, board: np.ndarray) -> None:
        self.state = SessionState.DONE
        self.result = board
        self.slot = None

    def fail(self, error: str) -> None:
        self.state = SessionState.FAILED
        self.error = error
        self.slot = None

    def cancel(self) -> None:
        self.state = SessionState.CANCELLED
        self.error = "cancelled by client"
        self.slot = None


@dataclass(frozen=True)
class SessionView:
    """Immutable snapshot returned by ``poll`` — callers never see (or
    mutate) the live Session the scheduler is driving."""

    sid: str
    state: SessionState
    steps: int
    steps_done: int
    result: np.ndarray | None
    error: str | None
    # the rule the session runs under — front-ends need it to label
    # results (an RLE export without its rule header is ambiguous)
    rule: str = ""
    # replay record: the PRNG seed (stochastic or seeded-board sessions)
    # and the ising temperature; None where not applicable
    seed: int | None = None
    temperature: float | None = None
    # execution-path attribution: whether a stochastic session is being
    # stepped by a bitplane-packed engine (and its lane width) — None
    # until admission, and always None for deterministic sessions
    packed: bool | None = None
    lanes: int | None = None
    # the OOM fallback ladder's stamp (None when the key never degraded)
    degraded_reason: str | None = None
    # the distributed-trace id (None when the session carries no trace
    # context) — echoed on the wire so clients and the doctor join on it
    trace_id: str | None = None
    # steering attribution: how many edit-log entries this session has
    # accumulated (0 for never-steered sessions — the wire render gates
    # on it so unsteered responses stay byte-stable)
    edits: int = 0
    # mega-board stamp: "RxC" when the session runs on a mesh slice,
    # None for single-chip sessions (the wire render gates on it)
    mesh: str | None = None
    # tenant stamp (docs/SERVING.md "Tenant QoS"): the resolved tenant
    # name, None for policy-less deployments (the wire render gates on
    # it so prior response shapes stay byte-identical)
    tenant: str | None = None

    @property
    def finished(self) -> bool:
        return self.state in TERMINAL


class SessionStore:
    """Issues ids and owns every session this service ever admitted.

    Terminal sessions stay resident so late ``poll`` calls still resolve;
    ``forget`` lets a long-lived service reclaim delivered results
    (without it a months-running process grows without bound — the
    serving twin of the driver's snapshot-retention concern).
    """

    def __init__(self):
        self._sessions: dict[str, Session] = {}
        self._counter = itertools.count()

    def create(self, **kwargs) -> Session:
        sid = f"s{next(self._counter):06d}"
        s = Session(sid=sid, **kwargs)
        self._sessions[sid] = s
        return s

    def get(self, sid: str) -> Session:
        try:
            return self._sessions[sid]
        except KeyError:
            raise UnknownSession(f"unknown session id {sid!r}") from None

    def view(self, sid: str) -> SessionView:
        s = self.get(sid)
        # absolute step space: a resumed session (start_step > 0) reports
        # total-trajectory progress, so a client polling through a worker
        # migration sees steps_done only ever grow
        return SessionView(
            sid=s.sid,
            state=s.state,
            steps=s.start_step + s.steps,
            steps_done=s.start_step + s.steps_done,
            result=s.result,
            error=s.error,
            rule=s.rule.name,
            seed=s.seed,
            temperature=s.temperature,
            packed=s.packed,
            lanes=s.lanes,
            degraded_reason=s.degraded_reason,
            trace_id=s.trace_id,
            edits=len(s.edits) + len(s.scheduled_edits),
            mesh=(f"{s.mesh[0]}x{s.mesh[1]}" if s.mesh is not None else None),
            tenant=s.tenant,
        )

    def result(self, sid: str) -> np.ndarray:
        """The DONE session's final board, or a typed error explaining why
        there is none (still in flight -> UnknownSession is wrong, so an
        unfinished session raises SessionFailed with a 'not finished'
        message only from FAILED/CANCELLED; in-flight raises ValueError)."""
        s = self.get(sid)
        if s.state is SessionState.DONE:
            assert s.result is not None
            return s.result
        if s.state in TERMINAL:
            raise SessionFailed(
                f"session {sid} {s.state.value}: {s.error or 'no result'}"
            )
        raise ValueError(f"session {sid} still {s.state.value}; poll later")

    def forget(self, sid: str) -> None:
        """Drop a TERMINAL session (delivered results are the caller's now)."""
        s = self.get(sid)
        if s.state not in TERMINAL:
            raise ValueError(f"cannot forget live session {sid} ({s.state.value})")
        del self._sessions[sid]

    def count(self, state: SessionState) -> int:
        return sum(1 for s in self._sessions.values() if s.state is state)

    def live(self) -> list[Session]:
        """Sessions not yet in a terminal state, in submission order."""
        return [s for s in self._sessions.values() if s.state not in TERMINAL]

    def live_by_tenant(self) -> dict[str, int]:
        """Live-session counts keyed by tenant name (sessions without a
        tenant stamp are skipped) — the quota check's and the per-tenant
        gauge's shared input."""
        out: dict[str, int] = {}
        for s in self._sessions.values():
            if s.state in TERMINAL or s.tenant is None:
                continue
            out[s.tenant] = out.get(s.tenant, 0) + 1
        return out

    def __len__(self) -> int:
        return len(self._sessions)
