"""The 2-D Ising model by checkerboard Metropolis, in plain PyTorch: the
reference of the ``ising-tc`` configuration.

A lattice is an int8 tensor ``[H, W]`` of 0 (spin down) and 1 (spin up),
periodic in both directions, J = 1 and h = 0.  A sweep is two half-sweeps:
the cells with ``(row + column) % 2 == 0`` first, then the others.  A cell
of the half's colour with ``n`` up neighbours (of its four) would change
the energy by ``dE = 2 s (2 n - 4)`` if it flipped, ``s`` its spin as +-1;
it flips at once where ``dE <= 0``, and where ``dE`` is 4 or 8 it flips
when its draw, read as a uint32, lies below ``floor(exp(-dE / T) * 2^32)``.

The draws are the stream the configuration states: word 0 of
Threefry-2x32 (20 rounds) under the key ``(seed mod 2^32, (seed >> 32) mod
2^32)`` at the counter ``(row * W + column, sweep * 4 + half)``, ``sweep``
the absolute sweep from the lattice's start and ``half`` 0 or 1.

Only the cells of the half's colour are hashed: in the ``[H, W/2, 2]``
view of the lattice, the rows whose index has the half's parity hold them
in column 0 of each pair, the other rows in column 1.

Imports nothing of the program under test.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.threefry import below, threefry2x32

SUBSTREAMS = 4  # draw families a sweep's counter word makes room for


def thresholds(temperature: float) -> tuple[int, int]:
    """The uint32 acceptance thresholds of dE = 4 and dE = 8."""
    t = float(temperature)
    out = []
    for de in (4, 8):
        p = math.exp(-de / t) if t > 0 else 0.0
        out.append(0 if p <= 0 else min(0xFFFFFFFF, int(p * 4294967296.0)))
    return out[0], out[1]


def _neighbours_up(board: torch.Tensor) -> torch.Tensor:
    return (torch.roll(board, 1, 0) + torch.roll(board, -1, 0)
            + torch.roll(board, 1, 1) + torch.roll(board, -1, 1))


def _colour(x: torch.Tensor, half: int) -> list[tuple[slice, torch.Tensor]]:
    """The cells of colour ``half`` of ``x`` [H, W], as the two row sets of
    the pair view: (rows, their cells [rows, W/2])."""
    h, w = x.shape
    pairs = x.view(h, w // 2, 2)
    return [(slice(half, None, 2), pairs[half::2, :, 0]),
            (slice(1 - half, None, 2), pairs[1 - half::2, :, 1])]


def decided_cells(board: torch.Tensor, half: int) -> int:
    """The cells of colour ``half`` whose move a draw decides (dE > 0)."""
    n4 = _neighbours_up(board)
    total = 0
    for (_, s), (_, n) in zip(_colour(board, half), _colour(n4, half)):
        idx = torch.where(s == 1, n, 4 - n)
        total += int((idx >= 3).sum())
    return total


def half_sweep(board: torch.Tensor, half: int, seed: int, sweep: int, temperature: float,
               rounds: int = 20) -> torch.Tensor:
    """One half-sweep of colour ``half`` at absolute sweep ``sweep``; a new
    lattice."""
    h, w = board.shape
    if w % 2 or h % 2 or h * w > 1 << 31:
        raise ValueError(f"the reference takes even edges and at most 2^31 cells, got {h}x{w}")
    thr3, thr4 = thresholds(temperature)
    k0, k1 = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    c1 = (sweep * SUBSTREAMS + half) & 0xFFFFFFFF
    n4 = _neighbours_up(board)
    out = board.clone()
    cols = 2 * torch.arange(w // 2, dtype=torch.int32, device=board.device)
    for column, ((rows, s), (_, n)) in enumerate(zip(_colour(board, half), _colour(n4, half))):
        r = torch.arange(h, dtype=torch.int32, device=board.device)[rows]
        c0 = (r * w + column)[:, None] + cols[None, :]
        u = threefry2x32(k0, k1, c0, c1, rounds)
        idx = torch.where(s == 1, n, 4 - n)
        accept = (idx <= 2) | ((idx == 3) & below(u, thr3)) | ((idx == 4) & below(u, thr4))
        out.view(h, w // 2, 2)[rows, :, column] = torch.where(accept, 1 - s, s)
    return out


def advance(board: torch.Tensor, sweeps: int, *, seed: int, start: int, temperature: float,
            rounds: int = 20) -> torch.Tensor:
    """``sweeps`` sweeps of ``board`` from absolute sweep ``start``."""
    for sweep in range(start, start + sweeps):
        for half in (0, 1):
            board = half_sweep(board, half, seed, sweep, temperature, rounds)
    return board


def control_advance(board: torch.Tensor, sweeps: int, **kwargs) -> torch.Tensor:
    """The control: the reference with its draws from Threefry-2x32 at 12
    rounds, the cheaper hash a kernel could be tempted to use, which breaks
    the stream the configuration states."""
    return advance(board, sweeps, rounds=12, **kwargs)

