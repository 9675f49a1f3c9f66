"""Pure-NumPy reference executor — the port's ground truth.

A copy of ``tpu_life/ops/reference.py``: the roll oracle every executor
of both packages is held to, whose ``step_np`` also routes the banded-matmul
counts (``stencil="matmul"``) and the continuous tier's float oracle.
"""

from __future__ import annotations

import numpy as np

from tpu_life_torch.models.rules import Rule


def neighbor_counts_np(
    board: np.ndarray,
    radius: int = 1,
    include_center: bool = False,
    neighborhood: str = "moore",
    boundary: str = "clamped",
) -> np.ndarray:
    """Live-neighbor counts; dead outside the board (clamped) or periodic
    wraparound (torus).  The boundary is a padding mode — zeros for
    clamped, wrap for torus — feeding one counting body."""
    alive = (board == 1).astype(np.int32)
    wrap = boundary == "torus"
    return _counts_np(alive, radius, include_center, neighborhood, wrap, wrap)


def _counts_np(
    alive: np.ndarray,
    radius: int,
    include_center: bool,
    neighborhood: str,
    row_wrap: bool,
    col_wrap: bool,
) -> np.ndarray:
    """The shared counting body with the boundary as a per-axis pad mode.
    Moore boxes are summed separably; von Neumann diamonds directly."""
    h, w = alive.shape
    padded = np.pad(
        alive, ((radius, radius), (0, 0)),
        mode="wrap" if row_wrap else "constant",
    )
    padded = np.pad(
        padded, ((0, 0), (radius, radius)),
        mode="wrap" if col_wrap else "constant",
    )
    counts = np.zeros((h, w), dtype=np.int32)
    if neighborhood == "von_neumann":
        for dy in range(-radius, radius + 1):
            half = radius - abs(dy)
            for dx in range(-half, half + 1):
                counts += padded[
                    radius + dy : radius + dy + h, radius + dx : radius + dx + w
                ]
    else:
        k = 2 * radius + 1
        rows = np.zeros((h, w + 2 * radius), dtype=np.int32)
        for dy in range(k):
            rows += padded[dy : dy + h, :]
        for dx in range(k):
            counts += rows[:, dx : dx + w]
    if not include_center:
        counts -= alive
    return counts


def step_np(board: np.ndarray, rule: Rule, stencil: str = "roll") -> np.ndarray:
    """One synchronous CA step via the rule's full transition LUT.

    ``stencil`` routes the counting executor: ``roll`` (the default —
    this module IS the roll oracle) or ``matmul`` (the banded-matmul
    path of ``ops.conv``, bit-identical for integer rules).  The
    continuous tier dispatches to its own float oracle.
    """
    if getattr(rule, "continuous", False):
        from tpu_life_torch.models import lenia

        return lenia.step_np(board, rule, stencil)
    if stencil == "matmul":
        from tpu_life_torch.ops.conv import neighbor_counts_matmul_np

        counts = neighbor_counts_matmul_np(board, rule)
    else:
        counts = neighbor_counts_np(
            board,
            rule.radius,
            rule.include_center,
            rule.neighborhood,
            rule.boundary,
        )
    return rule.transition_table[board.astype(np.int64), counts]


def run_np(
    board: np.ndarray, rule: Rule, steps: int, stencil: str = "roll"
) -> np.ndarray:
    for _ in range(steps):
        board = step_np(board, rule, stencil)
    return board
