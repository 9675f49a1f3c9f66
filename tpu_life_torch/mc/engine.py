"""Stochastic Runners: the ``run --rule ising`` / ``noisy:`` path (from
``tpu_life/mc/engine.py``).

Each Runner carries, besides the board, the **absolute step counter**
feeding the counter-based key schedule (``mc.prng``).  The counter
advances with the trajectory, never with the host loop, so chunking and
checkpoint/resume read the same stream: a Runner built with
``start_step`` re-enters the stream exactly where a snapshot left it.  The
counter is a Python int passed to every launch, so an advance needs no
host sync.

- :class:`MCHostRunner` / :class:`MCPackedHostRunner` — numpy ground
  truth on int8 cells / packed words (copies of the JAX package's).
- :class:`MCDeviceRunner` — int8 cells on a torch device (the JAX
  package's ``MCDeviceRunner``): route ``mc_roll`` for ``ising`` (the
  checkerboard sweep by roll, its draws over the whole lattice) and
  ``mc_noisy`` for ``noisy:`` rules.  Built by the ``cuda`` backend, the
  draws come from kernel K7 and a clamped Moore base step from kernel K2
  (``int8_tiled.int8_multi_step``, one step a launch), other bases from
  ``ops.stencil.make_step``; built by ``torch``, every part is plain ops.
- :class:`MCPackedDeviceRunner` — packed words on a torch device (the JAX
  package's ``MCPackedDeviceRunner``): route ``mc_packed``, a sweep of two
  half-sweeps, each one launch of kernel K6 when built by ``cuda`` (two
  buffers in turn), the plain half-sweep when built by ``torch``.

A kernel's wrapper runs its plain version on a CPU tensor, so the ``cuda``
backend's Runners take the same dispatch on ``--device cpu``.

The serving tier's stochastic engines (``serve.engine.make_engine`` sends
stochastic keys to :func:`make_mc_engine`) carry each slot's key halves,
absolute step counter and acceptance table beside its board, as tensors of
one entry a slot (``prng.SlotState``), so a temperature grid or an
ensemble of seeds shares one CompileKey and one build of the chunk:

- :class:`MCPackedBatchEngine` — ``cuda``, ising (the JAX package's
  ``MCPackedVmapEngine``): packed words, a chunk ``2 x chunk_steps``
  launches of K6's batch mode;
- :class:`MCBatchEngine` — ``cuda``, ``noisy:`` rules and ``--no-bitpack``
  ising (``MCVmapEngine``): int8 cells, the draws of every half-sweep or
  flip from K7's batch mode, a noisy rule's base step in plain ops over
  the batch;
- :class:`MCHostEngine` — ``numpy``: the ground truth (a copy of the JAX
  package's).

Both device engines are :class:`~tpu_life_torch.serve.engine.BatchEngine`s
(its device, streams, events and double buffer): a slot's counter advances
on the device by the sweeps the slot was live in the chunk (the JAX
chunk's ``s = s + live``), so a chunk needs nothing from the host, and a
peek of the in-flight chunk's input pairs with the lag the session
bookkeeping reports.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_life_torch.backends.torch_backend import DeviceRunner, from_words, to_words
from tpu_life_torch.mc import (
    ising,
    make_batch_step_fn,
    make_step_fn,
    packed_supports,
    require_key_schedule,
    validate_board_shape,
    validate_params,
)
from tpu_life_torch.mc import packed as packed_mod
from tpu_life_torch.mc.prng import SlotState, as_i32, key_halves
from tpu_life_torch.models.rules import IsingRule, NoisyRule, Rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.ops.stencil import live_count_cells
from tpu_life_torch.serve.engine import BatchEngine, CompileKey, EngineBase


def _thresholds_for(rule: Rule, temperature: float | None) -> np.ndarray:
    """uint32[5] acceptance table; zeros for rules that ignore it (the
    noisy flip probability is frozen in the rule)."""
    if isinstance(rule, IsingRule) and temperature is not None:
        return ising.acceptance_thresholds(temperature)
    return np.zeros(5, dtype=np.uint32)


# -- numpy ground truth ---------------------------------------------------------
class MCHostRunner:
    """NumPy ground-truth Runner for stochastic rules."""

    packed = False
    lanes = None

    def __init__(
        self,
        board: np.ndarray,
        rule: Rule,
        *,
        seed: int = 0,
        temperature: float | None = None,
        start_step: int = 0,
    ):
        validate_params(rule, temperature)
        self.board = np.asarray(board, np.int8)
        validate_board_shape(rule, self.board.shape)
        self.step = int(start_step)
        self._k0, self._k1 = key_halves(seed)
        self._thr = _thresholds_for(rule, temperature)
        self._fn = make_step_fn(np, rule)

    def advance(self, steps: int) -> None:
        for _ in range(steps):
            self.board = self._fn(
                self.board, self._k0, self._k1, np.uint32(self.step), self._thr
            )
            self.step += 1

    def sync(self) -> None:
        pass

    def fetch(self) -> np.ndarray:
        return self.board

    def snapshot(self):
        return lambda board=self.board: board

    def live_count(self) -> int:
        return int(np.count_nonzero(self.board == 1))


class MCPackedHostRunner:
    """NumPy Runner on the bitplane-packed spin layout (32 spins/lane) —
    bit-identical to :class:`MCHostRunner`.  Carries the wide (two-word)
    PRNG cell index, so it is the legal host executor for
    over-2^32-cell lattices."""

    packed = True
    lanes = packed_mod.LANES

    def __init__(
        self,
        board: np.ndarray,
        rule: Rule,
        *,
        seed: int = 0,
        temperature: float | None = None,
        start_step: int = 0,
    ):
        validate_params(rule, temperature)
        board = np.asarray(board, np.int8)
        validate_board_shape(rule, board.shape, wide_counter=True)
        self._shape = board.shape
        self.x = packed_mod.pack_board(board)
        self.step = int(start_step)
        self._k0, self._k1 = key_halves(seed)
        self._thr = _thresholds_for(rule, temperature)
        self._fn = packed_mod.make_sweep(np, rule, board.shape)

    def advance(self, steps: int) -> None:
        for _ in range(steps):
            self.x = self._fn(
                self.x,
                np.uint32(self._k0),
                np.uint32(self._k1),
                np.uint32(self.step),
                self._thr,
            )
            self.step += 1

    def sync(self) -> None:
        pass

    def fetch(self) -> np.ndarray:
        return packed_mod.unpack_board(self.x, self._shape[1])

    def snapshot(self):
        return lambda x=self.x, w=self._shape[1]: packed_mod.unpack_board(x, w)

    def live_count(self) -> int:
        return packed_mod.live_count(self.x)


# -- torch devices ----------------------------------------------------------------
def _k2_base(rule: Rule, shape: tuple[int, int]):
    """The noisy base step by kernel K2 at one step a launch, ping-ponging
    the board with a second buffer (on a CPU tensor, K2's plain version)."""
    from tpu_life_torch.kernels.int8_tiled import int8_multi_step

    spare = None

    def base(x: torch.Tensor) -> torch.Tensor:
        nonlocal spare
        if x.is_cuda and spare is None:
            spare = torch.empty_like(x)
        out = int8_multi_step(x, rule, shape, 1, block_steps=1, scratch=spare)
        if x.is_cuda:
            spare = x
        return out

    return base


class MCDeviceRunner(DeviceRunner):
    """Runner over int8 cells on ``device``: the roll path (``mc_roll``) for
    ``ising``, the base step then the flip (``mc_noisy``) for ``noisy:``.
    ``kernels`` (the ``cuda`` backend) draws through K7 and steps clamped
    Moore bases through K2; otherwise every part is plain torch ops."""

    packed = False
    lanes = None

    def __init__(
        self,
        board: np.ndarray,
        rule: Rule,
        *,
        seed: int = 0,
        temperature: float | None = None,
        start_step: int = 0,
        device: str | torch.device = "cpu",
        kernels: bool = False,
    ):
        from tpu_life_torch.kernels import int8_tiled, mc_threefry

        validate_params(rule, temperature)
        board = np.asarray(board, np.int8)
        validate_board_shape(rule, board.shape)
        self.step = int(start_step)
        k0, k1 = key_halves(seed)
        thr = _thresholds_for(rule, temperature)
        uniforms = mc_threefry.cell_uniforms if kernels else mc_threefry.cell_uniforms_plain
        base = (
            _k2_base(rule, board.shape)
            if kernels and isinstance(rule, NoisyRule) and int8_tiled.supports(rule)
            and rule.radius <= int8_tiled.MAX_RADIUS
            else None
        )
        fn = make_step_fn(torch, rule, uniforms=uniforms, base=base)

        def advance(x: torch.Tensor, n: int) -> torch.Tensor:
            for _ in range(n):
                x = fn(x, k0, k1, self.step, thr)
                self.step += 1
            return x

        # a copy even on the CPU: the runner's board is not the caller's array
        x = torch.from_numpy(board.copy()).to(device)
        route = "mc_roll" if isinstance(rule, IsingRule) else "mc_noisy"
        super().__init__(x, advance, lambda x: x.cpu().numpy(), live_count_cells, route)


class MCPackedDeviceRunner(DeviceRunner):
    """Runner over the packed words (int32[H, ceil(W/32)], the ``pack_np``
    layout) on ``device``, route ``mc_packed``: a sweep is the even then the
    odd half-sweep, through kernel K6 (``kernels``: the ``cuda`` backend)
    or its plain version.  Carries the wide two-word cell index.  Its
    sweep loop is ``DeviceRunner.advance``'s ``runner.advance`` profiler
    span, with no span a launch."""

    packed = True
    lanes = packed_mod.LANES

    def __init__(
        self,
        board: np.ndarray,
        rule: Rule,
        *,
        seed: int = 0,
        temperature: float | None = None,
        start_step: int = 0,
        device: str | torch.device = "cpu",
        kernels: bool = False,
    ):
        from tpu_life_torch.kernels import mc_threefry

        validate_params(rule, temperature)
        board = np.asarray(board, np.int8)
        validate_board_shape(rule, board.shape, wide_counter=True)
        if not packed_supports(rule):
            raise ValueError(f"the packed Metropolis path supports the ising rule family only, "
                             f"got {rule.name!r}")
        self.step = int(start_step)
        k0, k1 = key_halves(seed)
        thr = _thresholds_for(rule, temperature)
        thr3, thr4 = int(thr[3]), int(thr[4])
        w = board.shape[1]
        x = to_words(board, torch.device(device))
        half = (mc_threefry.packed_metropolis_half if kernels
                else mc_threefry.packed_metropolis_half_plain)
        spare = torch.empty_like(x) if x.is_cuda and kernels else None

        def advance(x: torch.Tensor, n: int) -> torch.Tensor:
            nonlocal spare
            for _ in range(n):
                for parity in (0, 1):
                    out = half(x, parity, k0, k1, self.step, thr3, thr4, width=w, out=spare)
                    if spare is not None:
                        spare = x
                    x = out
                self.step += 1
            return x

        super().__init__(x, advance, lambda x: from_words(x, w), bitlife.live_count_packed,
                         "mc_packed")


def mc_runner_for(
    backend,
    board: np.ndarray,
    rule: Rule,
    *,
    seed: int = 0,
    temperature: float | None = None,
    start_step: int = 0,
    packed: bool | None = None,
):
    """Runner factory for stochastic rules, dispatched on the backend.

    Only the ``mc.SUPPORTED_BACKENDS`` executors implement the
    counter-based key schedule; anything else is a typed rejection (never
    a silent deterministic fallback).

    ``packed`` selects the bitplane-packed Metropolis path (bit-identical
    to the roll path).  ``None`` = auto: the ``cuda`` and ``torch``
    backends honour their ``bitpack`` knob (``--no-bitpack`` opts out);
    numpy stays the int8 roll ground truth unless packed explicitly, so
    the oracle the tests byte-compare against never silently moves.
    """
    name = getattr(backend, "name", "") or type(backend).__name__
    require_key_schedule(rule, name)
    if packed is None:
        packed = (
            name in ("cuda", "torch")
            and getattr(backend, "bitpack", True)
            and packed_supports(rule)
        )
    elif packed and not packed_supports(rule):
        # an explicit packed=True must not silently measure the roll path
        raise ValueError(
            f"the packed Metropolis path supports the ising rule family "
            f"only, got {rule.name!r}"
        )
    kwargs = dict(seed=seed, temperature=temperature, start_step=start_step)
    if name in ("cuda", "torch"):
        device_kwargs = dict(device=backend.device, kernels=name == "cuda")
        if packed:
            return MCPackedDeviceRunner(board, rule, **kwargs, **device_kwargs)
        return MCDeviceRunner(board, rule, **kwargs, **device_kwargs)
    if packed:
        return MCPackedHostRunner(board, rule, **kwargs)
    return MCHostRunner(board, rule, **kwargs)


# -- batched serve engines --------------------------------------------------------
class MCBatchEngine(BatchEngine):
    """The stochastic device batch on int8 cells, the JAX package's
    ``MCVmapEngine``: route ``mc_roll`` (ising under ``--no-bitpack``) or
    ``mc_noisy``.  Each sweep of a chunk steps the whole batch under the
    freeze mask (``mc.make_batch_step_fn``), its draws from K7's batch mode
    (the plain version on the CPU).  Temperature and seed are not in the
    CompileKey, so the sessions of a sweep pack into one batch and one
    build."""

    ROUTES = ("mc_roll", "mc_noisy")
    packed = False

    def __init__(self, key: CompileKey, capacity: int, chunk_steps: int, *,
                 device: torch.device):
        self._staged = (0, None, 0)  # (seed, temperature, start_step) of the next load
        super().__init__(key, capacity, chunk_steps, route=self._route_of(key.rule),
                         device=device)

    @staticmethod
    def _route_of(rule: Rule) -> str:
        return "mc_roll" if isinstance(rule, IsingRule) else "mc_noisy"

    def _allocate(self, capacity: int, h: int, w: int) -> None:
        self._allocate_boards(capacity, h, w)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.device)

        self._k0, self._k1, self._counter = zeros(capacity), zeros(capacity), zeros(capacity)
        self._thr = zeros(capacity, 5)

    def _allocate_boards(self, capacity: int, h: int, w: int) -> None:
        self._boards = torch.zeros((capacity, h, w), dtype=torch.int8, device=self.device)

    def _state(self) -> SlotState:
        return SlotState(self._k0, self._k1, self._counter, self._thr, self._rem_dev)

    def load(self, slot, board, steps, *, seed=None, temperature=None, start_step=0):
        validate_params(self.key.rule, temperature)
        self._staged = (int(seed or 0), temperature, int(start_step))
        super().load(slot, board, steps)

    def _load_slot(self, slot: int, board: np.ndarray, steps: int) -> None:
        seed, temperature, start_step = self._staged
        k0, k1 = key_halves(seed)
        thr = torch.from_numpy(_thresholds_for(self.key.rule, temperature).view(np.int32))
        super()._load_slot(slot, board, steps)
        with self._on(), self._compute():
            self._k0[slot] = as_i32(k0)
            self._k1[slot] = as_i32(k1)
            self._counter[slot] = as_i32(start_step)
            self._thr[slot].copy_(thr)

    def _clear_slot(self, slot: int) -> None:
        self._staged = (0, None, 0)
        self._load_slot(slot, np.zeros(self.key.shape, np.int8), 0)

    def _build_chunk(self) -> None:
        from tpu_life_torch import obs

        obs.instant(
            "serve.compile",
            rule=self.key.rule.name,
            shape=f"{self.key.shape[0]}x{self.key.shape[1]}",
            backend=self.key.backend,
            packed=self.packed,
        )
        self.compile_count += 1
        self._build_step()

    def _build_step(self) -> None:
        from tpu_life_torch.kernels import mc_threefry

        self._step = make_batch_step_fn(self.key.rule, uniforms=mc_threefry.cell_uniforms_batch)

    def _run_chunk(self, boards: torch.Tensor) -> torch.Tensor:
        # new tensors each sweep: the chunk never writes its input (_prev)
        state = self._state()
        for t in range(self.chunk_steps):
            boards = self._step(boards, state, t)
        return boards

    def _state_after(self) -> dict[str, torch.Tensor]:
        # a frozen slot's counter freezes with its board: the stream
        # position is a function of trajectory progress, not of how many
        # chunks the slot sat in the batch
        counter = self._counter + self._rem_dev.clamp(max=self.chunk_steps)
        return {**super()._state_after(), "_counter": counter}


class MCPackedBatchEngine(MCBatchEngine):
    """The packed stochastic device batch, the JAX package's
    ``MCPackedVmapEngine``: :class:`MCBatchEngine`'s per-slot state with the
    boards as packed words (int32[S, H, ceil(W/32)], the ``pack_np``
    layout), a sweep two launches of K6's batch mode (the plain version on
    the CPU) that ping-pong between the two packed buffers that are not
    the chunk's input.  Boards pack on load and unpack on peek, so every
    caller above the engine still speaks int8."""

    ROUTES = ("mc_packed",)
    packed = True
    lanes = packed_mod.LANES

    @staticmethod
    def _route_of(rule: Rule) -> str:
        return "mc_packed"

    def _allocate_boards(self, capacity: int, h: int, w: int) -> None:
        self._bufs = self._packed_buffers(capacity, h, w)
        self._boards = self._bufs[0]

    def _encode(self, board: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(packed_mod.pack_board(board).view(np.int32))

    def _decode(self, words: np.ndarray) -> np.ndarray:
        return packed_mod.unpack_board(words.view(np.uint32), self.key.shape[1])

    def _build_step(self) -> None:
        pass  # the chunk is K6's batch mode's launches

    def _run_chunk(self, src: torch.Tensor) -> torch.Tensor:
        from tpu_life_torch.kernels.mc_threefry import packed_metropolis_half_batch

        spare = [b for b in self._bufs if b is not src]
        state = self._state()
        out = src
        for t in range(self.chunk_steps):
            for parity in (0, 1):
                dst = spare[0] if out is not spare[0] else spare[1]
                out = packed_metropolis_half_batch(out, parity, state, width=self.key.shape[1],
                                                   offset=t, out=dst)
        return out


class MCHostEngine(EngineBase):
    """NumPy executor on the batch layout — the ground truth the device
    engines' equivalence tests pin against (a copy of the JAX package's;
    the same role as ``HostBatchEngine`` for deterministic rules)."""

    packed = False

    def __init__(self, key: CompileKey, capacity: int, chunk_steps: int):
        super().__init__(key, capacity, chunk_steps)
        h, w = key.shape
        self._boards = np.zeros((capacity, h, w), dtype=np.int8)
        self._keys = [(0, 0)] * capacity
        self._steps_abs = np.zeros(capacity, dtype=np.int64)
        self._thrs: list[np.ndarray] = [np.zeros(5, np.uint32) for _ in range(capacity)]
        self._fn = make_step_fn(np, key.rule)
        self._staged = (0, None, 0)

    def load(self, slot, board, steps, *, seed=None, temperature=None, start_step=0):
        validate_params(self.key.rule, temperature)
        self._staged = (int(seed or 0), temperature, int(start_step))
        super().load(slot, board, steps)

    def _load_slot(self, slot: int, board: np.ndarray, steps: int) -> None:
        seed, temperature, start_step = self._staged
        self._boards[slot] = board
        self._keys[slot] = key_halves(seed)
        self._steps_abs[slot] = start_step
        self._thrs[slot] = _thresholds_for(self.key.rule, temperature)

    def _clear_slot(self, slot: int) -> None:
        self._boards[slot] = 0
        self._staged = (0, None, 0)

    def _dispatch_impl(self) -> None:
        pass  # deferred: the chunk runs at collect time (outside the lock)

    def _collect_impl(self, advanced: dict[int, int]) -> None:
        for slot, n in advanced.items():
            k0, k1 = self._keys[slot]
            b = self._boards[slot]
            base = int(self._steps_abs[slot])
            for i in range(n):
                b = self._fn(b, k0, k1, np.uint32(base + i), self._thrs[slot])
            self._boards[slot] = b
            self._steps_abs[slot] = base + n

    def _peek_board(self, slot: int) -> np.ndarray:
        # deferred-compute executor: pre-chunk state until collect runs
        return self._boards[slot].copy()


def make_mc_engine(
    key: CompileKey, capacity: int, chunk_steps: int, *, packed: bool | None = None,
    device: str | torch.device | None = None,
) -> EngineBase:
    """Engine factory for stochastic CompileKeys (the JAX package's): a
    typed rejection (``StochasticBackendError``) for executors without the
    key schedule (``sharded``, ``mesh:RxC``), whose slot loops would run a
    different, irreproducible trajectory.

    ``packed=None`` (auto) runs ising batches on the packed device engine
    (K6's batch mode), bit-identical to the roll engine; ``packed=False``
    (``--no-bitpack``) pins the roll engine.  The numpy executor stays the
    roll ground truth either way.  ``device`` is the card (None: the
    current one) or the CPU, for the device engines.
    """
    require_key_schedule(key.rule, key.backend)
    use_packed = (packed is None or packed) and packed_supports(key.rule)
    validate_board_shape(key.rule, key.shape, wide_counter=use_packed and key.backend == "cuda")
    if key.backend == "cuda":
        from tpu_life_torch.backends.base import resolve_device

        cls = MCPackedBatchEngine if use_packed else MCBatchEngine
        return cls(key, capacity, chunk_steps, device=resolve_device(device))
    return MCHostEngine(key, capacity, chunk_steps)
