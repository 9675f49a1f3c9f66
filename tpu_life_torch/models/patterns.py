"""Well-known CA patterns and random boards.

A copy of ``tpu_life/models/patterns.py``: the named patterns of ``pattern
list`` / ``pattern import --name``, ``place``, ``empty``, and
``random_board``, the board ``gen`` writes (``np.random.default_rng(seed)``,
as in the JAX package, so the bytes match).
"""

from __future__ import annotations

import numpy as np


def _p(rows: list[str]) -> np.ndarray:
    return np.array([[int(c) for c in r] for r in rows], dtype=np.int8)


def _rle(text: str) -> np.ndarray:
    # larger patterns are defined via their published RLE strings through
    # the port's own parser (tpu_life_torch/io/rle.py)
    from tpu_life_torch.io.rle import parse_rle

    return parse_rle(text)[0]


BLOCK = _p(["11", "11"])  # still life
BLINKER = _p(["111"])  # period-2 oscillator
TOAD = _p(["0111", "1110"])  # period-2 oscillator
BEACON = _p(["1100", "1100", "0011", "0011"])  # period-2 oscillator
GLIDER = _p(["010", "001", "111"])  # moves (+1, +1) every 4 steps
LWSS = _p(["01111", "10001", "00001", "10010"])  # lightweight spaceship
R_PENTOMINO = _p(["011", "110", "010"])  # methuselah
PULSAR = _rle(  # period-3 oscillator, 13x13
    "x = 13, y = 13\n"
    "2b3o3b3o2b$13b$o4bobo4bo$o4bobo4bo$o4bobo4bo$2b3o3b3o2b$13b$"
    "2b3o3b3o2b$o4bobo4bo$o4bobo4bo$o4bobo4bo$13b$2b3o3b3o2b!"
)
GOSPER_GLIDER_GUN = _rle(  # emits one glider every 30 steps
    "x = 36, y = 9\n"
    "24bo$22bobo$12b2o6b2o12b2o$11bo3bo4b2o12b2o$2o8bo5bo3b2o$"
    "2o8bo3bob2o4bobo$10bo5bo7bo$11bo3bo$12b2o!"
)


def place(board: np.ndarray, pattern: np.ndarray, top: int, left: int) -> np.ndarray:
    """Return a copy of ``board`` with ``pattern`` stamped at (top, left)."""
    out = board.copy()
    h, w = pattern.shape
    out[top : top + h, left : left + w] = pattern
    return out


def empty(height: int, width: int) -> np.ndarray:
    return np.zeros((height, width), dtype=np.int8)


def random_board(
    height: int,
    width: int,
    density: float = 0.5,
    *,
    states: int = 2,
    seed: int = 0,
) -> np.ndarray:
    """Random board matching the reference's ~50%-density uniform init."""
    rng = np.random.default_rng(seed)
    alive = rng.random((height, width)) < density
    if states == 2:
        return alive.astype(np.int8)
    state = rng.integers(1, states, size=(height, width), dtype=np.int8)
    return np.where(alive, state, 0).astype(np.int8)
