"""Conway's Life (B3/S23) in plain PyTorch: the reference of the
``life-b3s23`` configuration.

Boards are int8 tensors of 0 and 1, ``[H, W]`` or a batch ``[B, H, W]``.
A step sums each cell's 3 x 3 block, itself included, as a sum of three
rows of a copy padded by one cell, then of three columns: with dead,
clamped edges the padding is zeros (the reference program's contract), and
on a torus it is the opposite edge.  A cell is alive after the step when
its block holds 3 live cells, or 4 and it is alive itself: born with 3
neighbours, surviving with 2 or 3.

Imports nothing of the program under test.
"""

from __future__ import annotations

import torch


def _pad(board: torch.Tensor, torus: bool) -> torch.Tensor:
    h, w = board.shape[-2:]
    if not torus:
        padded = board.new_zeros((*board.shape[:-2], h + 2, w + 2))
        padded[..., 1:-1, 1:-1] = board
        return padded
    rows = torch.cat([board[..., -1:, :], board, board[..., :1, :]], dim=-2)
    return torch.cat([rows[..., -1:], rows, rows[..., :1]], dim=-1)


def step(board: torch.Tensor, *, torus: bool = False) -> torch.Tensor:
    """One generation of every board in ``board``."""
    h, w = board.shape[-2:]
    padded = _pad(board, torus)
    rows = padded[..., :h, :] + padded[..., 1:h + 1, :] + padded[..., 2:, :]
    block = rows[..., :w] + rows[..., 1:w + 1] + rows[..., 2:]
    return ((block == 3) | ((block == 4) & (board == 1))).to(torch.int8)


def advance(board: torch.Tensor, steps: int, *, torus: bool = False, **_) -> torch.Tensor:
    """``steps`` generations of ``board`` (left unchanged).  Keywords that
    other configurations' references take (a seed, a step offset) mean
    nothing to a deterministic rule."""
    for _ in range(steps):
        board = step(board, torus=torus)
    return board


def control_advance(board: torch.Tensor, steps: int, **kwargs) -> torch.Tensor:
    """The control: the reference with the configuration's clamped, dead
    edge replaced by a torus, the guarantee a kernel could be tempted to
    drop (its halo then needs no edge case)."""
    return advance(board, steps, torus=True)

