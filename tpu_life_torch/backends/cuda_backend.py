"""The ``cuda`` backend: life-like runs through the packed stripe kernel.

The counterpart of ``tpu_life/backends/pallas_backend.py``'s
``PallasBackend`` (``prepare``, ``_prepare_packed``, ``_make_runner``),
rebuilt for the GPU:

- clamped life-like rules go through kernel K1
  (``kernels.packed_stripe.packed_multi_step``) at every board size — the
  TPU backend's small-board fallback existed for Mosaic's alignment rules,
  which a CUDA kernel does not have;
- the board is the unframed ``pack_np`` layout, int32[H, ceil(W/32)]: the
  kernel loads zeros outside the board, so there is no frame to pad or to
  re-zero;
- each advance of n steps is ``n // block_steps`` launches plus one
  remainder launch, ping-ponging two buffers allocated once;
- every other rule raises ``NotImplementedError`` naming its ROADMAP item.

``CudaBackend(device="cpu")`` runs the same dispatch, blocking and
remainder logic over the plain version; that is how the CPU tests reach
it.  Without a card, the default device raises ``CudaUnavailableError``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_life_torch.backends.base import (
    ChunkCallback,
    register_backend,
    resolve_device,
    run_with_runner,
)
from tpu_life_torch.backends.torch_backend import (
    DeviceRunner,
    require_life_like,
    to_words,
)
from tpu_life_torch.kernels.packed_stripe import MAX_BLOCK_STEPS, packed_multi_step
from tpu_life_torch.models.rules import Rule

# substeps per kernel launch: device-memory traffic falls as 1/k while the
# row-halo recompute grows with k (ext rows = tile_rows + 2k per tile)
DEFAULT_BLOCK_STEPS = 8


@register_backend("cuda")
class CudaBackend:
    name = "cuda"

    def __init__(self, *, device=None, block_steps: int | None = None, **_):
        self.device = resolve_device(device)
        self.block_steps = DEFAULT_BLOCK_STEPS if block_steps is None else block_steps
        if not 1 <= self.block_steps <= MAX_BLOCK_STEPS:
            raise ValueError(
                f"block_steps must be in [1, {MAX_BLOCK_STEPS}], got {self.block_steps}"
            )

    def prepare(self, board: np.ndarray, rule: Rule) -> DeviceRunner:
        require_life_like(rule, self.name)
        h, w = board.shape
        x = to_words(board, self.device)
        # the second buffer of the ping-pong; the plain version on the CPU
        # allocates its own results instead
        spare = torch.empty_like(x) if x.is_cuda else None

        def advance(x, n):
            nonlocal spare
            out = packed_multi_step(
                x, rule, (h, w), n, block_steps=self.block_steps, scratch=spare
            )
            if x.is_cuda and out is not x:
                spare = x
            return out

        return DeviceRunner(x, advance, w)

    def run(
        self,
        board: np.ndarray,
        rule: Rule,
        steps: int,
        *,
        chunk_steps: int = 0,
        callback: ChunkCallback | None = None,
    ) -> np.ndarray:
        return run_with_runner(
            self, board, rule, steps, chunk_steps=chunk_steps, callback=callback
        )
