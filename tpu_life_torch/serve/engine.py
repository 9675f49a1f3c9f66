"""Batched step engines: many tenant lattices through one chunk program
(the port of ``tpu_life/serve/engine.py``).

An engine owns a **fixed-capacity padded batch** of boards plus a per-slot
``remaining`` step vector.  Continuous batching falls out of two
properties, as in the JAX package:

- the chunk has *constant shapes* — capacity, board geometry and chunk
  length never vary — so sessions join and leave between chunks with one
  build of the chunk per engine (``compile_count == 1`` across any churn);
- per-slot step budgets are enforced *inside* the chunk: a slot whose
  budget is spent keeps its board.  One chunk therefore advances each slot
  by exactly ``min(chunk_steps, remaining[slot])`` steps, bit-identical to
  independent runs.

The executors behind one interface, and the JAX executor each stands for:

- :class:`BatchEngine` — ``cuda``: the device batch, the counterpart of
  ``VmapEngine``.  Route ``k1_batch`` keeps the batch bit-packed and
  advances a chunk with K1's batch mode (``kernels.packed_batch``), every
  slot in each launch of ``packed_batch.chunk_plan`` (a whole chunk of up
  to ``32 // radius`` steps in one launch on boards of at most 1024
  columns, launches of K1's depth of 8 on wider ones), the budgets read on
  the device; route ``ops`` steps an int8 (or float32) batch with the
  plain step over a slot axis under the freeze mask, the literal
  ``VmapEngine``.
- :class:`HostBatchEngine` — ``numpy``: the ground-truth executor.
- :class:`SlotLoopEngine` — ``sharded``: one ``Runner`` per slot of the
  port's sharded backend (kernels K3 and K4 per shard); ``cuda``'s
  clamped Moore int8 rules that K1 does not take: one Runner per slot of
  the ``cuda`` backend (kernel K2), as the JAX package's ``pallas`` serve
  backend loops its Runners over slots; and the host backends ``stripes``
  and ``native``, one host Runner a slot, as in the JAX package.

``tuned`` resolves each CompileKey through the autotune cache's read
path (``autotune.resolve_backend_kwargs``: a cache hit, else the cost
model; never a measurement) and serves the pick as ``--serve-backend <pick>`` would; a
``torch`` pick, which has no serve backend of its own, is a
:class:`SlotLoopEngine` over the ``torch`` backend (the JAX generic
branch).

Stochastic keys (``ising``, ``noisy:``) go to the engines of
``mc/engine.py``: on ``cuda`` the device batches ``MCPackedBatchEngine``
(K6's batch mode) and ``MCBatchEngine`` (K7's batch mode), subclasses of
:class:`BatchEngine`, and on ``numpy`` ``MCHostEngine``; ``sharded`` and
``mesh:RxC`` refuse them typed (``mc.StochasticBackendError``).

:func:`cuda_route` fixes a ``cuda`` key's executor when its engine is
built, never on a failure: ``k1_batch`` for the rules K1 takes, ``k2_slots``
for the rest of the clamped Moore int8 rules, and ``ops`` for the rules no
kernel counts (torus rules, von Neumann rules past K1's diamond, the
continuous tier).

The chunk API is split into **dispatch / collect** so the pipelined pump
can overlap device compute with host work: ``dispatch_chunk()`` launches
one chunk and returns at once with the per-slot accounting;
``collect_chunk()`` blocks until it is materialized; ``settle()`` blocks
only until ``fetch()`` of *frozen* slots cannot stall.

The double buffer under CUDA stream order: a device engine keeps the
in-flight chunk's *input* batch (``_prev``), so a slot frozen during the
chunk is read from ``_prev`` while the chunk still runs.  So a chunk never
writes ``_prev``: route ``k1_batch`` rotates three packed buffers (the
chunk's launches ping-pong between the two that are not its input), and
route ``ops`` makes new tensors.  Each engine runs on its own stream and
reads boards on a second one, which waits on an event recorded where the
newest chunk began (``_prev`` ready) or at the read (the newest board).
Every method names its device and streams itself, because the pipelined
pump settles on another thread than the one that dispatched, and the
current stream is per thread.  A chunk whose launch raises moves none of
this: its output and state are committed only once every launch was
issued, and the chunk in flight is waited for, so a salvage after the
fault reads a board that matches its lag (the JAX package's
``VmapEngine`` moves ``_prev`` first and replays a chunk twice there).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from tpu_life_torch import chaos
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.runtime.metrics import log

#: serve backends whose engines live on the card (``BatchEngine`` and the
#: K2 slot loop): the executors of the JAX package's ``jax`` and ``pallas``
DEVICE_BATCH_BACKENDS = ("cuda",)
#: serve backends with a float path for the continuous tier, besides
#: ``mesh:RxC``; ``tuned`` resolves per CompileKey to one of the others
#: (or ``torch``)
FLOAT_SERVE_BACKENDS = ("cuda", "numpy", "sharded", "tuned")
#: every serve backend the port runs, besides ``mesh:RxC``
SERVE_BACKENDS = (*FLOAT_SERVE_BACKENDS, "stripes", "native")
#: serve backends that step on the host and need no card
HOST_BACKENDS = ("numpy", "stripes", "native")


def check_backend(name: str) -> None:
    """Refuse a serve backend this port does not run (ValueError)."""
    if name not in SERVE_BACKENDS and not str(name).startswith("mesh:"):
        raise ValueError(
            f"unknown serve backend {name!r}; choose from {', '.join(SERVE_BACKENDS)}"
        )


def require_float_path(rule: Rule, backend: str) -> None:
    """The serving tier's float gate: continuous rules run on the device
    batch (``cuda``), the numpy oracle and ``sharded`` (served by the
    oracle, as the JAX package serves them on ``sharded``)."""
    if backend not in FLOAT_SERVE_BACKENDS and not str(backend).startswith("mesh:"):
        raise ValueError(
            f"continuous rule {rule.name!r} needs the cuda, numpy or sharded "
            f"serve backend (float32 boards; {backend!r} has no float path) — a "
            f"quantized fallback would not be the rule you asked for"
        )


@dataclass(frozen=True)
class CompileKey:
    """What must match for two sessions to share one batch.

    Admission groups sessions by this key (scheduler.py); each key owns
    one engine, one chunk program, one set of slots.  ``Rule`` is a
    frozen hashable value, so the key is usable as a dict key directly.
    """

    rule: Rule
    shape: tuple[int, int]  # (height, width)
    dtype: str  # board element type ("int8"; "float32" on the continuous tier)
    backend: str  # executor family ("cuda" / "numpy" / "sharded" / "mesh:RxC")
    # the resolved counting path: "roll" shift-adds or "matmul" banded
    # matmuls, resolved per rule at submit (ops.conv.resolve_stencil)
    stencil: str = "roll"


def compile_key_for(
    rule: Rule, board: np.ndarray, backend: str, stencil: str = "roll"
) -> CompileKey:
    return CompileKey(
        rule=rule,
        shape=(int(board.shape[0]), int(board.shape[1])),
        dtype=rule.board_dtype,
        backend=backend,
        stencil=stencil,
    )


class EngineBase:
    """Slot bookkeeping shared by every executor (the JAX package's
    ``EngineBase``, unchanged in behaviour).

    ``compile_count`` counts builds of the batched chunk — the expensive
    event continuous batching exists to avoid.  It stays at 1 per engine
    no matter how many sessions churn through.
    """

    #: True for executors whose ``dispatch_chunk`` may be called while a
    #: previous chunk is still in flight (the device path: the stream
    #: orders the chunks, so rolling never blocks the host).  Host
    #: executors auto-collect first — their "in-flight" chunk is deferred
    #: *host* compute that would otherwise be silently dropped.
    ASYNC_ROLL = False

    #: Observability stamps: ``packed`` True/False on the stochastic
    #: engines (None on deterministic ones), ``lanes`` the spins-per-word
    #: of a packed engine.  The scheduler copies them onto each admitted
    #: session.
    packed: bool | None = None
    lanes: int | None = None

    def __init__(self, key: CompileKey, capacity: int, chunk_steps: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
        self.key = key
        self.capacity = capacity
        self.chunk_steps = chunk_steps
        # the board element dtype this engine stores and steps — int8
        # everywhere but the continuous tier's float32 boards
        self.dtype = np.dtype(getattr(key, "dtype", "int8"))
        # the per-key stencil stamp: which counting path this engine runs
        self.stencil = (
            None
            if getattr(key.rule, "stochastic", False)
            else getattr(key, "stencil", "roll")
        )
        self.compile_count = 0
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        self._remaining = np.zeros(capacity, dtype=np.int64)
        # the in-flight chunk's {slot: steps} accounting (empty = none)
        self._inflight: dict[int, int] = {}
        # a LOST chunk's accounting: collect raised after the in-flight
        # map was already cleared, so these steps are accounted to the
        # sessions but their results are unreachable — the in-place
        # recovery (scheduler.recover_engine) reads this to rewind each
        # session to its newest materialized state.
        self._lost: dict[int, int] = {}
        # set by the service while this engine settles OUTSIDE the lock:
        # verb-triggered slot releases must defer to the pump meanwhile
        self.busy = False
        # device-idle bookkeeping: wall time this engine sat with no chunk
        # in flight between a collect and the next dispatch (real time,
        # independent of any injected test clock)
        self.idle_seconds = 0.0
        self._idle_reported = 0.0
        self._idle_since: float | None = None

    # -- slot lifecycle ----------------------------------------------------
    def acquire(self) -> int | None:
        """Claim a free slot (None when the batch is full)."""
        return self._free.pop() if self._free else None

    def release(self, slot: int) -> None:
        """Return a slot to the pool; its lattice is zeroed with budget 0.
        The slot also leaves any uncollected chunk's accounting."""
        self._remaining[slot] = 0
        self._inflight.pop(slot, None)
        self._lost.pop(slot, None)
        self._clear_slot(slot)
        self._free.append(slot)

    def occupancy(self) -> int:
        return self.capacity - len(self._free)

    def load(
        self,
        slot: int,
        board: np.ndarray,
        steps: int,
        *,
        seed: int | None = None,
        temperature: float | None = None,
        start_step: int = 0,
    ) -> None:
        """Stage a session's lattice into ``slot`` with ``steps`` budget.
        ``seed``/``temperature``/``start_step`` are the stochastic tier's
        per-slot state; deterministic engines ignore them."""
        h, w = self.key.shape
        if board.shape != (h, w):
            raise ValueError(
                f"board shape {board.shape} does not match engine key {self.key.shape}"
            )
        self._remaining[slot] = steps
        self._load_slot(slot, np.asarray(board, self.dtype), steps)

    def remaining(self, slot: int) -> int:
        return int(self._remaining[slot])

    # -- the batched chunk: dispatch / collect ------------------------------
    @property
    def inflight(self) -> bool:
        """True while a dispatched chunk has not been collected."""
        return bool(self._inflight)

    def dispatch_chunk(self) -> dict[int, int]:
        """Launch one chunk that advances every occupied slot by
        ``min(chunk_steps, remaining)`` steps; returns that per-slot
        accounting immediately, without waiting for the result."""
        if self._inflight and not self.ASYNC_ROLL:
            self.collect_chunk()
        advanced = {
            s: min(self.chunk_steps, int(r))
            for s, r in enumerate(self._remaining)
            if r > 0
        }
        if advanced:
            # chaos seams: a launch-time device fault and a launch-time
            # OOM, both raised BEFORE any state moves, so the engine stays
            # consistent and the scheduler recovers this key in place
            chaos.inject("engine.dispatch")
            chaos.inject("engine.oom")
            now = time.monotonic()
            if self._idle_since is not None:
                self.idle_seconds += now - self._idle_since
                self._idle_since = None
            self._dispatch_impl()
            self._remaining = np.maximum(self._remaining - self.chunk_steps, 0)
            self._inflight = advanced
        return advanced

    def collect_chunk(self) -> dict[int, int]:
        """Block until the in-flight chunk (if any) is fully materialized;
        returns its {slot: steps} accounting."""
        adv, self._inflight = self._inflight, {}
        if adv:
            self._chaos_wedge()
            try:
                # chaos seam: the chunk's materialization fails; its
                # accounting lands in ``_lost`` for in-place recovery
                chaos.inject("engine.collect")
                self._collect_impl(adv)
            except BaseException:
                for slot, n in adv.items():
                    self._lost[slot] = self._lost.get(slot, 0) + n
                raise
            self._idle_since = time.monotonic()
        return adv

    def clear_lost(self) -> None:
        """Forget a lost chunk's accounting."""
        self._lost.clear()

    def _chaos_wedge(self) -> None:
        # chaos seam: a wedged device — the chunk wait stalls instead of
        # raising; fired from collect AND the device settle path, which
        # is what the service's settle-deadline watchdog exists to catch
        hang = chaos.delay("engine.wedge")
        if hang > 0:
            log.warning("chaos: engine wedging %.1fs (engine.wedge)", hang)
            time.sleep(hang)

    def settle(self) -> None:
        """Finish enough in-flight work that ``fetch()`` of *frozen* slots
        cannot stall.  Host executors run their deferred chunk here; the
        device executor overrides to wait for everything but its newest
        chunk."""
        self.collect_chunk()

    def advance_chunk(self) -> dict[int, int]:
        """Dispatch one chunk and wait for it — the synchronous round's
        quantum."""
        advanced = self.dispatch_chunk()
        self.collect_chunk()
        return advanced

    def idle_seconds_delta(self) -> float:
        """Idle seconds accumulated since this was last called."""
        delta = self.idle_seconds - self._idle_reported
        self._idle_reported = self.idle_seconds
        return delta

    def fetch(self, slot: int) -> np.ndarray:
        """The slot's materialized board — guarded: the scheduler only
        ever fetches frozen slots."""
        self._fetch_guard(slot)
        return self._peek_board(slot)

    def peek_slot(self, slot: int) -> tuple[np.ndarray, int]:
        """The newest MATERIALIZED board for a resident slot, plus how many
        already-accounted steps that board lags the session bookkeeping
        (the in-flight chunk's steps for this slot; 0 when settled)."""
        return self._peek_board(slot), self._inflight.get(slot, 0)

    def salvage_slot(self, slot: int) -> tuple[np.ndarray, int]:
        """After a chunk-level fault: the newest *trustworthy* board for a
        resident slot, plus its lag — the in-flight chunk's steps plus a
        LOST chunk's."""
        lag = self._inflight.get(slot, 0) + self._lost.get(slot, 0)
        return self._peek_board(slot), lag

    def _peek_board(self, slot: int) -> np.ndarray:
        raise NotImplementedError

    def _fetch_guard(self, slot: int) -> None:
        if slot in self._inflight:
            raise RuntimeError(
                f"slot {slot} is being stepped by an in-flight chunk; "
                f"collect_chunk() before fetch"
            )

    # -- executor hooks ----------------------------------------------------
    def _load_slot(self, slot: int, board: np.ndarray, steps: int) -> None:
        raise NotImplementedError

    def _clear_slot(self, slot: int) -> None:
        raise NotImplementedError

    def _dispatch_impl(self) -> None:
        """Launch (device) or stage (host) one chunk of work."""
        raise NotImplementedError

    def _collect_impl(self, advanced: dict[int, int]) -> None:
        """Materialize the chunk ``_dispatch_impl`` launched."""
        raise NotImplementedError


class BatchEngine(EngineBase):
    """The device batch: the counterpart of the JAX package's
    ``VmapEngine`` (see the module docstring for its routes and its double
    buffer).  ``device`` is a CUDA device, or the CPU, where every tensor
    op runs in plain PyTorch and K1's batch mode runs its plain version."""

    ASYNC_ROLL = True
    ROUTES = ("k1_batch", "ops")
    #: chunks every BatchEngine of the process dispatched, beside K1's
    #: batch-mode launch count (``packed_batch_multi_step.launches``)
    dispatched = 0

    def __init__(
        self,
        key: CompileKey,
        capacity: int,
        chunk_steps: int,
        *,
        route: str,
        device: torch.device,
    ):
        super().__init__(key, capacity, chunk_steps)
        if route not in self.ROUTES:
            raise ValueError(f"route must be one of {self.ROUTES}, got {route!r}")
        from tpu_life_torch.kernels import packed_batch

        if route == "k1_batch" and not packed_batch.supports(key.rule):
            raise ValueError(f"route k1_batch does not take rule {key.rule.name!r}")
        self.route = route
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        if cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        with self._on():
            if cuda:
                self._stream = torch.cuda.Stream(self.device)
                self._copy = torch.cuda.Stream(self.device)
            else:
                self._stream = self._copy = None
            with self._compute():
                self._allocate(capacity, *key.shape)
                self._rem_dev = torch.zeros(capacity, dtype=torch.int32, device=self.device)
        self._prev: torch.Tensor | None = None  # the in-flight chunk's input batch
        #: slots loaded since the newest dispatch: only ``_boards`` holds
        #: them (the in-flight chunk's input never saw them)
        self._fresh: set[int] = set()
        self._prev_ready = None  # event: every chunk but the newest is done
        self._done = None  # event: the newest chunk is done
        self._step = None  # the batched step (route ops), built at the first chunk
        self.chunks = 0  # chunks this engine dispatched

    def _allocate(self, capacity: int, h: int, w: int) -> None:
        """The board batch on the device, on the compute stream."""
        if self.route == "k1_batch":
            from tpu_life_torch.kernels import packed_batch, packed_stripe

            self._bufs = self._packed_buffers(capacity, h, w)
            self._boards = self._bufs[0]
            # the card's SMs size the plan's tiles (the CPU runs the plain
            # version, whatever its tiles)
            self._n_sm = (packed_stripe.sm_count(self.device.index) if self._stream is not None
                          else packed_batch.H100_SMS)
        else:
            dt = torch.float32 if self.dtype == np.float32 else torch.int8
            self._boards = torch.zeros((capacity, h, w), dtype=dt, device=self.device)

    def _packed_buffers(self, capacity: int, h: int, w: int) -> list[torch.Tensor]:
        """Three batches of packed words: a chunk's launches ping-pong
        between the two that are not its input (``_prev``)."""
        from tpu_life_torch.ops import bitlife

        return [torch.zeros((capacity, h, bitlife.packed_width(w)), dtype=torch.int32,
                            device=self.device) for _ in range(3)]

    # -- streams -------------------------------------------------------------
    def _on(self):
        """The engine's device as the current one (the CPU: nothing)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _compute(self):
        """The engine's compute stream as the current one."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _event(self):
        """An event recorded now on the compute stream (None on the CPU)."""
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev

    # -- the chunk -----------------------------------------------------------
    def _build_chunk(self):
        from tpu_life_torch import obs

        # the span marks the event so a serve trace shows which round built
        # the chunk for which key
        obs.instant(
            "serve.compile",
            rule=self.key.rule.name,
            shape=f"{self.key.shape[0]}x{self.key.shape[1]}",
            backend=self.key.backend,
            stencil=self.stencil,
        )
        self.compile_count += 1
        if self.route == "ops":
            from tpu_life_torch.ops.stencil import make_step

            self._step = make_step(self.key.rule, self.stencil or "roll", self.key.shape)

    def _chunk_k1_batch(self, src: torch.Tensor) -> torch.Tensor:
        from tpu_life_torch.kernels.packed_batch import chunk_plan, packed_batch_multi_step

        spare = [b for b in self._bufs if b is not src]
        out = src
        for launch in chunk_plan(self.key.rule, self.key.shape, self.chunk_steps,
                                 self.capacity, self._n_sm):
            dst = spare[0] if out is not spare[0] else spare[1]
            out = packed_batch_multi_step(out, self._rem_dev, self.key.rule, self.key.shape,
                                          launch.k, out=dst, offset=launch.offset)
        return out

    def _chunk_ops(self, boards: torch.Tensor) -> torch.Tensor:
        # the freeze mask: at step t a slot steps while its budget at the
        # chunk's start exceeds t (VmapEngine's carry r > 0, r - 1 a step)
        rem = self._rem_dev.view(-1, 1, 1)
        for t in range(self.chunk_steps):
            boards = torch.where(rem > t, self._step(boards), boards)
        return boards

    def _run_chunk(self, boards: torch.Tensor) -> torch.Tensor:
        """Launch one chunk from ``boards`` (never written) on the compute
        stream and return the tensor it leaves the batch in."""
        if self.route == "k1_batch":
            return self._chunk_k1_batch(boards)
        return self._chunk_ops(boards)

    def _state_after(self) -> dict[str, torch.Tensor]:
        """The device state a chunk leaves behind, as new tensors by
        attribute name, issued after its launches."""
        return {"_rem_dev": (self._rem_dev - self.chunk_steps).clamp_(min=0)}

    def _dispatch_impl(self) -> None:
        if self.compile_count == 0:
            self._build_chunk()
        # the chunk's output and state are locals until every launch was
        # issued: a launch that raises leaves the engine as it was
        with self._on(), self._compute():
            ready = self._event()
            try:
                boards = self._run_chunk(self._boards)
                state = self._state_after()
            except BaseException:
                self._settle_after_fault()
                raise
            done = self._event()
        self._prev, self._prev_ready, self._done = self._boards, ready, done
        self._boards = boards
        for name, tensor in state.items():
            setattr(self, name, tensor)
        self._fresh.clear()
        self.chunks += 1
        BatchEngine.dispatched += 1

    def _settle_after_fault(self) -> None:
        """After a chunk whose launches raised: wait for the in-flight
        chunk, so its slots read its output with no lag.  Its input
        (``_prev``) is no longer safe to read, since the failed launches
        may have written that buffer (routes that rotate three)."""
        advanced, self._inflight = self._inflight, {}
        if not advanced:
            return
        try:
            self._collect_impl(advanced)
        except RuntimeError:
            # the context is poisoned: the in-flight chunk is lost too
            for slot, n in advanced.items():
                self._lost[slot] = self._lost.get(slot, 0) + n

    def _collect_impl(self, advanced: dict[int, int]) -> None:
        if self._done is not None:
            self._done.synchronize()
        self._prev = None

    def settle(self) -> None:
        # wait for every chunk but the newest: _prev is the newest chunk's
        # input, i.e. the previous chunk's output — once it is ready, every
        # frozen slot fetches without blocking, and the host never runs
        # more than one chunk ahead of the device
        self._chaos_wedge()
        if self._prev is not None and self._prev_ready is not None:
            self._prev_ready.synchronize()

    # -- slots ---------------------------------------------------------------
    def _encode(self, board: np.ndarray) -> torch.Tensor:
        """A board as the batch holds it, on the host."""
        if self.route == "k1_batch":
            from tpu_life_torch.ops import bitlife

            return torch.from_numpy(bitlife.pack_np(board).view(np.int32))
        return torch.from_numpy(np.ascontiguousarray(board))

    def _decode(self, words: np.ndarray) -> np.ndarray:
        """A slot of the batch, copied to the host, as a board."""
        if self.route == "k1_batch":
            from tpu_life_torch.ops import bitlife

            return bitlife.unpack_np(words.view(np.uint32), self.key.shape[1])
        return words

    def _load_slot(self, slot: int, board: np.ndarray, steps: int) -> None:
        host = self._encode(board)
        # on the compute stream, after any chunk that reads the batch
        with self._on(), self._compute():
            self._boards[slot].copy_(host)
            self._rem_dev[slot] = int(steps)
        self._fresh.add(slot)

    def _clear_slot(self, slot: int) -> None:
        with self._on(), self._compute():
            self._boards[slot].zero_()
            self._rem_dev[slot] = 0

    def _peek_board(self, slot: int) -> np.ndarray:
        # the double buffer is the newest MATERIALIZED state while a chunk
        # flies: a slot frozen in that chunk has the same value in its
        # input as in its output, so it reads here instead of waiting for
        # the newest chunk; a slot the chunk IS stepping reads its
        # pre-chunk state, which peek_slot's lag accounts for.  A LOST
        # chunk reads the same way.  A slot loaded after the chunk's
        # dispatch is not in its input: it reads the newest batch (the
        # JAX package's VmapEngine reads the stale input there, ROADMAP §C)
        stale = self._inflight or self._lost
        if stale and self._prev is not None and slot not in self._fresh:
            src, ready = self._prev, self._prev_ready
        else:
            src, ready = self._boards, None
        with self._on():
            if self._copy is None:
                words = src[slot].numpy().copy()
            else:
                if ready is None:
                    ready = self._event()
                with torch.cuda.stream(self._copy):
                    self._copy.wait_event(ready)
                    view = src[slot]
                    view.record_stream(self._copy)
                    words = view.to("cpu").numpy()
        return self._decode(words)


class HostBatchEngine(EngineBase):
    """The numpy executor on the same batch layout — the truth executor the
    equivalence tests pin the device engine against.  Its chunk "dispatch"
    only stages the work; the compute runs in ``_collect_impl``, which the
    pipelined pump calls from ``settle()`` outside the service lock."""

    def __init__(self, key: CompileKey, capacity: int, chunk_steps: int):
        super().__init__(key, capacity, chunk_steps)
        h, w = key.shape
        self._boards = np.zeros((capacity, h, w), dtype=self.dtype)
        # the per-slot step function, built ONCE per engine: the numpy
        # roll oracle for discrete keys, the float oracle for continuous
        # keys, and the matmul counting body when the key's stencil pins it
        rule = key.rule
        stencil = self.stencil or "roll"
        if getattr(rule, "continuous", False):
            from tpu_life_torch.models.lenia import make_lenia_step_np

            self._step = make_lenia_step_np(rule, (h, w), stencil)
        elif stencil == "matmul":
            from tpu_life_torch.ops.conv import make_counts_matmul_np

            counts_fn = make_counts_matmul_np(rule, (h, w))
            table = rule.transition_table
            self._step = lambda b: table[b.astype(np.int64), counts_fn(b)]
        else:
            from tpu_life_torch.ops.reference import step_np

            self._step = lambda b: step_np(b, rule)

    def _load_slot(self, slot: int, board: np.ndarray, steps: int) -> None:
        self._boards[slot] = board

    def _clear_slot(self, slot: int) -> None:
        self._boards[slot] = 0

    def _dispatch_impl(self) -> None:
        pass  # deferred: the chunk runs at collect time (see class doc)

    def _collect_impl(self, advanced: dict[int, int]) -> None:
        for slot, n in advanced.items():
            b = self._boards[slot]
            for _ in range(n):
                b = self._step(b)
            self._boards[slot] = b

    def _peek_board(self, slot: int) -> np.ndarray:
        # while a chunk is staged the array still holds the PRE-chunk
        # state, which is exactly what peek_slot's lag accounting expects
        return self._boards[slot].copy()


class SlotLoopEngine(EngineBase):
    """For executors with no batch axis (``sharded``, and ``cuda``'s K2
    keys): one device-resident ``Runner`` per slot via ``make_runner``,
    advanced slot by slot each chunk.  Each runner builds its own step, so
    ``compile_count`` stays 0 here by design."""

    def __init__(self, key: CompileKey, capacity: int, chunk_steps: int, backend):
        super().__init__(key, capacity, chunk_steps)
        self._backend = backend
        self._runners: dict[int, object] = {}

    def _load_slot(self, slot: int, board: np.ndarray, steps: int) -> None:
        from tpu_life_torch.backends.base import make_runner

        self._runners[slot] = make_runner(self._backend, board, self.key.rule)

    def _clear_slot(self, slot: int) -> None:
        self._runners.pop(slot, None)

    def _dispatch_impl(self) -> None:
        pass  # deferred: runners advance at collect time, like the host engine

    def _collect_impl(self, advanced: dict[int, int]) -> None:
        for slot, n in advanced.items():
            runner = self._runners.get(slot)
            if runner is not None:  # slot released since dispatch: work is moot
                runner.advance(n)

    def _peek_board(self, slot: int) -> np.ndarray:
        return np.asarray(self._runners[slot].fetch())


def make_host_engine(key: CompileKey, capacity: int, chunk_steps: int) -> EngineBase:
    """The key's host twin, the bottom rung of the OOM ladder (the JAX
    package's ``make_host_engine``): when a device engine OOMs even at a
    halved chunk, the scheduler demotes the key to the bit-identical
    numpy executor (``HostBatchEngine``, ``MCHostEngine`` for stochastic
    keys) so its sessions finish, slower, instead of failing typed."""
    if getattr(key.rule, "stochastic", False):
        from tpu_life_torch.mc.engine import MCHostEngine

        return MCHostEngine(key, capacity, chunk_steps)
    return HostBatchEngine(key, capacity, chunk_steps)


def cuda_route(rule: Rule) -> str:
    """The executor of a ``cuda`` key (see the module docstring):
    ``k1_batch`` and ``ops`` are ``BatchEngine`` routes, ``k2_slots`` the
    slot loop over the ``cuda`` backend's K2 Runners."""
    from tpu_life_torch.kernels import int8_tiled, packed_batch

    if getattr(rule, "continuous", False):
        return "ops"
    if packed_batch.supports(rule):
        return "k1_batch"
    if int8_tiled.supports(rule):
        return "k2_slots"
    return "ops"


def make_engine(
    key: CompileKey,
    capacity: int,
    chunk_steps: int,
    *,
    mc_packed: bool | None = None,
    device: str | torch.device | None = None,
) -> EngineBase:
    """Engine factory, dispatched on the key's executor family (the JAX
    package's ``make_engine`` under the port's backend names).  ``device``
    is the card (None: the current one) or the CPU, for the device engines;
    ``mc_packed`` is the stochastic tier's bitplane knob
    (``ServeConfig.mc_packed`` / ``--no-bitpack``), which deterministic
    keys ignore."""
    if getattr(key.rule, "stochastic", False):
        # stochastic keys go to the MC engines (per-slot seed, temperature
        # and step counter); executors without the key schedule are a
        # typed rejection there, never a silent fallback
        from tpu_life_torch.mc.engine import make_mc_engine

        return make_mc_engine(key, capacity, chunk_steps, packed=mc_packed, device=device)
    if str(key.backend).startswith("mesh:"):
        # mega-board tier (serve/mesh_engine.py): capacity pinned to 1
        from tpu_life_torch.serve.mesh_engine import MeshEngine

        return MeshEngine(key, chunk_steps, device=device)
    check_backend(key.backend)
    backend_name = key.backend
    backend_kwargs: dict = {}
    if backend_name == "tuned":
        # read path only (cache hit or the cost model): serving never pays
        # a measurement; a pick is served as --serve-backend <pick> is
        from tpu_life_torch import autotune

        backend_name, tuned, source = autotune.resolve_backend_kwargs(
            key.rule, key.shape, backend_kwargs, mode="cache", device=device)
        log.info("serve: autotune %s -> %s (%s)", key.rule.name, tuned.describe(), source)
    if backend_name == "torch":
        # a torch pick has no serve backend of its own: the JAX generic
        # branch, one torch Runner a slot (float boards included)
        from tpu_life_torch.backends.base import get_backend

        return SlotLoopEngine(
            key, capacity, chunk_steps,
            get_backend("torch", rule=key.rule, device=device, **backend_kwargs),
        )
    if getattr(key.rule, "continuous", False):
        # continuous keys need a float executor: the device batch (route
        # ops) or the numpy oracle, which also serves them on 'sharded'
        # as the JAX package's does — a slot-loop backend would cast float
        # boards to int8
        require_float_path(key.rule, backend_name)
        if backend_name not in DEVICE_BATCH_BACKENDS:
            return HostBatchEngine(key, capacity, chunk_steps)
    if backend_name == "numpy":
        return HostBatchEngine(key, capacity, chunk_steps)
    from tpu_life_torch.backends.base import get_backend, resolve_device

    if backend_name == "cuda":
        route = cuda_route(key.rule)
        if route != "k2_slots":
            return BatchEngine(key, capacity, chunk_steps, route=route,
                               device=resolve_device(device))

    return SlotLoopEngine(
        key, capacity, chunk_steps,
        get_backend(backend_name, rule=key.rule, device=device, **backend_kwargs),
    )
