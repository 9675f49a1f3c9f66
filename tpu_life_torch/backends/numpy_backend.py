"""Pure-NumPy backend: the single-process ground truth, over the port's
own copy of the oracle (``tpu_life_torch.ops.reference``)."""

from __future__ import annotations

import numpy as np

from tpu_life_torch.backends.base import ChunkCallback, chunk_sizes, register_backend
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops.conv import make_counts_matmul_np, resolve_stencil, validate_stencil
from tpu_life_torch.ops.reference import step_np


@register_backend("numpy")
class NumpyBackend:
    name = "numpy"

    def __init__(self, *, stencil: str = "auto", **_):
        # the counting-path knob (--stencil): "auto" keeps this executor on
        # the roll path, the oracle the matmul path is held to; an explicit
        # "matmul" runs the banded-matmul counts here too
        self.stencil = validate_stencil(stencil)

    def run(
        self,
        board: np.ndarray,
        rule: Rule,
        steps: int,
        *,
        chunk_steps: int = 0,
        callback: ChunkCallback | None = None,
    ) -> np.ndarray:
        stencil = resolve_stencil(rule, self.stencil, "numpy")
        if getattr(rule, "continuous", False):
            from tpu_life_torch.models import lenia

            board = lenia.validate_board(board, rule)
            fn = lenia.make_lenia_step_np(rule, board.shape, stencil)
        elif stencil == "matmul":
            board = np.asarray(board, dtype=np.int8)
            counts_fn = make_counts_matmul_np(rule, board.shape)
            table = rule.transition_table
            fn = lambda b: table[b.astype(np.int64), counts_fn(b)]  # noqa: E731
        else:
            board = np.asarray(board, dtype=np.int8)
            fn = lambda b: step_np(b, rule)  # noqa: E731
        done = 0
        for n in chunk_sizes(steps, chunk_steps):
            for _ in range(n):
                board = fn(board)
            done += n
            if callback is not None:
                b = board
                callback(done, lambda b=b: b)
        return board
