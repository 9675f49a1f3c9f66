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
backend's Runners take the same dispatch on ``--device cpu``.  The batched
serve engines of the JAX module (``MCVmapEngine``, ``MCHostEngine``,
``MCPackedVmapEngine``, ``make_mc_engine``) go with serving (ROADMAP A9).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_life_torch.backends.torch_backend import DeviceRunner, from_words, to_words
from tpu_life_torch.mc import (
    ising,
    make_step_fn,
    packed_supports,
    require_key_schedule,
    validate_board_shape,
    validate_params,
)
from tpu_life_torch.mc import packed as packed_mod
from tpu_life_torch.mc.prng import key_halves
from tpu_life_torch.models.rules import IsingRule, NoisyRule, Rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.ops.stencil import live_count_cells


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
    or its plain version.  Carries the wide two-word cell index."""

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
