"""The int8 stencil in plain PyTorch: one CA step as a few tensor passes.

The counterpart of ``tpu_life/ops/stencil.py`` on torch tensors, on any
device.  It is the plain version the hand-written int8 kernel
(``tpu_life_torch/kernels/int8_tiled.py``) is held to, and the executor of
the rules no kernel counts (the backends' ``stencil`` route: torus rules on
the unpadded board, and the von Neumann rules the bit-sliced diamond does
not take).

- the neighbour count is a *separable* box sum over a padded array —
  (2r+1) row shifts then (2r+1) column shifts for Moore boxes, direct
  shifted adds for von Neumann diamonds.  The boundary is only the padding
  mode: zeros for the clamped board, wraparound for the torus.
- only state 1 counts as alive; Generations' dying states (2 .. C-1) count
  as dead.
- the rule is compare/selects over the birth and survive sets
  (:func:`apply_rule`), with Generations decay.

Counts are int32 (exact for (2r+1)^2 at any radius); the board stays int8.
:func:`make_step`'s ``stencil`` picks the counting path: ``roll`` (the
shift-adds above) or ``matmul`` (the banded matmuls of ``ops.conv``,
bit-identical); continuous rules get the float Lenia step
(``models.lenia``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops.common import contiguous_ranges


def neighbor_counts(
    board: torch.Tensor,
    radius: int = 1,
    include_center: bool = False,
    neighborhood: str = "moore",
    boundary: str = "clamped",
) -> torch.Tensor:
    """int32 live-neighbour counts; dead outside the array (clamped) or
    periodic (torus).  Torus counting assumes the array IS the logical
    board (no physical padding)."""
    alive = (board == 1).to(torch.int32)
    wrap = boundary == "torus"
    return _counts(alive, radius, include_center, neighborhood, wrap, wrap)


def _pad(x: torch.Tensor, radius: int, axis: int, wrap: bool) -> torch.Tensor:
    """``x`` padded by ``radius`` on both sides of ``axis``: zeros, or the
    periodic continuation (``np.pad`` mode ``wrap``, any radius)."""
    if wrap:
        n = x.shape[axis]
        idx = torch.arange(-radius, n + radius, device=x.device) % n
        return x.index_select(axis, idx)
    return F.pad(x, (0, 0, radius, radius) if axis == 0 else (radius, radius))


def pad_board(x: torch.Tensor, radius: int, wrap: bool) -> torch.Tensor:
    """``x`` padded by ``radius`` on all four sides: zeros, or the periodic
    continuation."""
    return _pad(_pad(x, radius, 0, wrap), radius, 1, wrap)


def _counts(
    alive: torch.Tensor,
    radius: int,
    include_center: bool,
    neighborhood: str,
    row_wrap: bool,
    col_wrap: bool,
) -> torch.Tensor:
    """The shared counting body, with the boundary expressed per axis as a
    padding mode (rows clamped and columns wrapped is the sharded torus's
    per-shard substep)."""
    h, w = alive.shape
    padded = _pad(_pad(alive, radius, 0, row_wrap), radius, 1, col_wrap)
    if neighborhood == "von_neumann":
        counts = None
        for dy in range(-radius, radius + 1):
            half = radius - abs(dy)
            row = padded[radius + dy : radius + dy + h, :]
            for dx in range(-half, half + 1):
                c = row[:, radius + dx : radius + dx + w]
                counts = c if counts is None else counts + c
    else:
        k = 2 * radius + 1
        rows = padded[0:h, :]
        for dy in range(1, k):
            rows = rows + padded[dy : dy + h, :]
        counts = rows[:, 0:w]
        for dx in range(1, k):
            counts = counts + rows[:, dx : dx + w]
    if not include_center:
        counts = counts - alive
    return counts


def make_wrap_cols_step(rule: Rule) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-shard substep of the sharded torus: columns wrap in place (a
    shard of a 1-D row mesh holds whole rows, so the east-west seam is
    local) while rows see zero padding — the real north-south neighbours
    arrive as halo rows stacked around the shard by the closed ring, and
    the fringe the zero rows corrupt is dropped after each block."""

    def step(board: torch.Tensor) -> torch.Tensor:
        alive = (board == 1).to(torch.int32)
        counts = _counts(
            alive, rule.radius, rule.include_center, rule.neighborhood,
            row_wrap=False, col_wrap=True,
        )
        return apply_rule(board, counts, rule)

    return step


def _membership(counts: torch.Tensor, values: frozenset) -> torch.Tensor:
    """Branch-free ``counts in values`` as range compares."""
    m = torch.zeros(counts.shape, dtype=torch.bool, device=counts.device)
    for lo, hi in contiguous_ranges(values):
        if lo == hi:
            m = m | (counts == lo)
        else:
            m = m | ((counts >= lo) & (counts <= hi))
    return m


def apply_rule(board: torch.Tensor, counts: torch.Tensor, rule: Rule) -> torch.Tensor:
    """Next state from (state, count): the transition table as
    compare/selects, in ``board``'s dtype."""
    dt = board.dtype

    def const(v: int) -> torch.Tensor:
        return torch.tensor(v, dtype=dt, device=board.device)

    one, zero = const(1), const(0)
    born = _membership(counts, rule.birth)
    survives = _membership(counts, rule.survive)
    if rule.states == 2:
        alive = board == 1
        return torch.where(
            alive, torch.where(survives, one, zero), torch.where(born, one, zero)
        )
    dying_next = torch.where(board >= rule.states - 1, zero, (board + one).to(dt))
    nxt = torch.where(
        board == 0,
        torch.where(born, one, zero),
        torch.where(board == 1, torch.where(survives, one, const(2)), dying_next),
    )
    return nxt.to(dt)


def validity_mask(
    shape: tuple[int, int],
    logical_shape: tuple[int, int],
    row_offset: torch.Tensor | int = 0,
    col_offset: torch.Tensor | int = 0,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Bool mask of the cells that exist on the *logical* board.

    Padding cells must stay dead forever: a cell outside the logical board
    that flipped alive would leak births back across the clamped edge.
    ``row_offset``/``col_offset`` are the global indices of physical cell
    (0, 0)."""
    h, w = shape
    lh, lw = logical_shape
    grow = row_offset + torch.arange(h, device=device)
    gcol = col_offset + torch.arange(w, device=device)
    return ((grow >= 0) & (grow < lh))[:, None] & ((gcol >= 0) & (gcol < lw))[None, :]


def _per_shape(make: Callable[[tuple[int, int]], Callable]) -> Callable:
    """A step that builds ``make(shape)`` at the first board of each shape
    it is given and keeps it (the matmul operators are shape-static)."""
    cache: dict[tuple[int, int], Callable] = {}

    def step(board: torch.Tensor) -> torch.Tensor:
        shape = tuple(board.shape)
        fn = cache.get(shape)
        if fn is None:
            fn = cache[shape] = make(shape)
        return fn(board)

    return step


def make_step(
    rule: Rule, stencil: str = "roll", shape: tuple[int, int] | None = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """One full-array CA step: ``int8[h, w] -> int8[h, w]`` for discrete
    rules, ``f32 -> f32`` for continuous ones.  ``stencil`` picks the
    neighbour count: ``roll`` (shift-adds) or ``matmul`` (banded matmuls,
    ``ops.conv``: bit-identical for integer rules).  The matmul operators
    belong to one board shape: with ``shape`` they are built now, without
    it at the first board of each shape."""
    from tpu_life_torch.ops.conv import validate_stencil

    validate_stencil(stencil)
    if getattr(rule, "continuous", False):
        from tpu_life_torch.models.lenia import make_lenia_step

        make = lambda s: make_lenia_step(rule, s, stencil)  # noqa: E731
    elif stencil == "matmul":
        from tpu_life_torch.ops.conv import make_counts_matmul

        def make(s):
            counts = make_counts_matmul(rule, s)
            return lambda board: apply_rule(board, counts(board), rule)
    else:
        def step(board: torch.Tensor) -> torch.Tensor:
            counts = neighbor_counts(
                board, rule.radius, rule.include_center, rule.neighborhood, rule.boundary
            )
            return apply_rule(board, counts, rule)

        return step
    return make(tuple(shape)) if shape is not None else _per_shape(make)


def make_masked_step(
    rule: Rule, logical_shape: tuple[int, int], stencil: str = "roll"
) -> Callable[..., torch.Tensor]:
    """A step that also pins physical padding cells dead (see
    :func:`validity_mask`)."""
    if getattr(rule, "continuous", False):
        # continuous boards run unpadded; the int8 padding mask would
        # corrupt a float board
        raise ValueError("continuous rules cannot run on padded/masked boards")
    if rule.boundary == "torus":
        # padding would sit between the logical edges the torus glues
        # together; torus boards run unpadded (exact shape)
        raise ValueError(
            "torus boundary cannot run on padded/masked boards; keep the "
            "board at its exact logical shape"
        )
    step = make_step(rule, stencil)

    def masked(
        board: torch.Tensor,
        row_offset: torch.Tensor | int = 0,
        col_offset: torch.Tensor | int = 0,
    ) -> torch.Tensor:
        mask = validity_mask(
            tuple(board.shape), logical_shape, row_offset, col_offset, board.device
        )
        return torch.where(mask, step(board), torch.zeros((), dtype=torch.int8, device=board.device))

    return masked


def multi_step(
    board: torch.Tensor,
    *,
    rule: Rule,
    steps: int,
    logical_shape: tuple[int, int] | None = None,
    stencil: str = "roll",
) -> torch.Tensor:
    """``steps`` CA steps as a Python loop; masked where ``logical_shape``
    is smaller than the board.  ``board`` itself is never written.  Each
    call builds its step (on ``matmul`` the operators too); a runner that
    advances many times builds one with :func:`make_step` instead."""
    if logical_shape is None or tuple(logical_shape) == tuple(board.shape):
        step = make_step(rule, stencil, tuple(board.shape))
    else:
        step = make_masked_step(rule, tuple(logical_shape), stencil)
    for _ in range(steps):
        board = step(board)
    return board


def live_count_cells(x: torch.Tensor) -> torch.Tensor:
    """Live-cell (state == 1) count of an int8 board as one int64 scalar
    tensor on ``x``'s device."""
    return (x == 1).sum(dtype=torch.int64)
