"""State carried between the JAX package and this one, as plain values.

The state of a run is a board and a rule.  These helpers take numpy arrays
and plain Python values only — never an object of the JAX package — so a
caller holding both packages (the tests) can hand the same state to each.
Files need no helper: both packages share the byte codec, so one's
``output.txt`` is a valid input for the other.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_life_torch.backends.torch_backend import from_words
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops import bitlife


def board_from_reference(
    board: np.ndarray, logical_shape: tuple[int, int]
) -> torch.Tensor:
    """A JAX-package board — packed ``uint32[H, ceil(W/32)]`` words (the
    ``pack_np`` layout) or ``int8[H, W]`` states — as this package's
    int32 words on the CPU."""
    h, w = logical_shape
    board = np.asarray(board)
    if board.dtype == np.uint32:
        want = (h, bitlife.packed_width(w))
        if board.shape != want:
            raise ValueError(f"packed board has shape {board.shape}, want {want}")
        words = np.ascontiguousarray(board)
    elif board.dtype == np.int8:
        if board.shape != (h, w):
            raise ValueError(f"board has shape {board.shape}, want {(h, w)}")
        words = bitlife.pack_np(board)
    else:
        raise TypeError(f"board must be uint32 words or int8 states, got {board.dtype}")
    return torch.from_numpy(words.view(np.int32).copy())


def board_to_reference(x: torch.Tensor, logical_shape: tuple[int, int]) -> np.ndarray:
    """This package's int32 words (any device) as an ``int8[H, W]`` board."""
    return from_words(x, logical_shape[1])


def rule_from_fields(
    name: str,
    birth,
    survive,
    states: int = 2,
    radius: int = 1,
    neighborhood: str = "moore",
    boundary: str = "clamped",
    include_center: bool = False,
) -> Rule:
    """A :class:`Rule` from the field values of a JAX-package rule."""
    return Rule(
        name=name,
        birth=frozenset(int(c) for c in birth),
        survive=frozenset(int(c) for c in survive),
        radius=int(radius),
        states=int(states),
        include_center=bool(include_center),
        neighborhood=neighborhood,
        boundary=boundary,
    )
