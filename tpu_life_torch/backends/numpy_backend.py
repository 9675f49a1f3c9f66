"""Pure-NumPy backend: the single-process ground truth, over the port's
own copy of the oracle (``tpu_life_torch.ops.reference``)."""

from __future__ import annotations

import numpy as np

from tpu_life_torch.backends.base import ChunkCallback, chunk_sizes, register_backend
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops.reference import step_np


@register_backend("numpy")
class NumpyBackend:
    name = "numpy"

    def __init__(self, **_):
        pass

    def run(
        self,
        board: np.ndarray,
        rule: Rule,
        steps: int,
        *,
        chunk_steps: int = 0,
        callback: ChunkCallback | None = None,
    ) -> np.ndarray:
        board = np.asarray(board, dtype=np.int8)
        done = 0
        for n in chunk_sizes(steps, chunk_steps):
            for _ in range(n):
                board = step_np(board, rule)
            done += n
            if callback is not None:
                b = board
                callback(done, lambda b=b: b)
        return board
