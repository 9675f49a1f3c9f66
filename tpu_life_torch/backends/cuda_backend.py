"""The ``cuda`` backend: clamped Moore rules through the hand-written kernels.

The counterpart of ``tpu_life/backends/pallas_backend.py``'s
``PallasBackend`` (``prepare``, ``_prepare_packed``, ``_make_runner``),
rebuilt for the GPU:

- clamped life-like rules with ``bitpack`` on (the default) go through
  kernel K1 (``kernels.packed_stripe.packed_multi_step``) on the unframed
  ``pack_np`` words, int32[H, ceil(W/32)];
- every other clamped Moore rule — Generations, Larger-than-Life, and
  life-like rules with ``bitpack=False`` — goes through kernel K2
  (``kernels.int8_tiled.int8_multi_step``) on the unframed int8[H, W]
  board, its block depth clamped to the rule's radius as the TPU backend
  clamps it;
- both at every board size: the TPU backend's small-board fallback existed
  for Mosaic's alignment rules, which a CUDA kernel does not have.  Each
  kernel loads zeros outside the board, so there is no frame to pad or to
  re-zero;
- each advance of n steps is ``n // block_steps`` launches plus one
  remainder launch, ping-ponging two buffers allocated once;
- von Neumann and torus rules raise ``NotImplementedError`` naming their
  ROADMAP item.

``CudaBackend(device="cpu")`` runs the same dispatch, blocking and
remainder logic over the plain versions; that is how the CPU tests reach
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
    from_words,
    require_clamped_moore,
    to_words,
)
from tpu_life_torch.kernels.int8_tiled import clamp_block_steps, int8_multi_step
from tpu_life_torch.kernels.packed_stripe import MAX_BLOCK_STEPS, packed_multi_step
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.ops.stencil import live_count_cells

# substeps per kernel launch: device-memory traffic falls as 1/k while the
# halo recompute grows with k (K1: ext rows = tile_rows + 2k per tile)
DEFAULT_BLOCK_STEPS = 8


@register_backend("cuda")
class CudaBackend:
    name = "cuda"

    def __init__(
        self, *, device=None, block_steps: int | None = None, bitpack: bool = True, **_
    ):
        self.device = resolve_device(device)
        self.block_steps = DEFAULT_BLOCK_STEPS if block_steps is None else block_steps
        if not 1 <= self.block_steps <= MAX_BLOCK_STEPS:
            raise ValueError(
                f"block_steps must be in [1, {MAX_BLOCK_STEPS}], got {self.block_steps}"
            )
        self.bitpack = bitpack

    def prepare(self, board: np.ndarray, rule: Rule) -> DeviceRunner:
        require_clamped_moore(rule, self.name)
        if self.bitpack and bitlife.supports(rule):
            return self._prepare_packed(board, rule)
        return self._prepare_int8(board, rule)

    def _prepare_packed(self, board: np.ndarray, rule: Rule) -> DeviceRunner:
        """Kernel K1 over the packed words."""
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

        return DeviceRunner(
            x, advance, lambda x: from_words(x, w), bitlife.live_count_packed
        )

    def _prepare_int8(self, board: np.ndarray, rule: Rule) -> DeviceRunner:
        """Kernel K2 over the int8 board."""
        h, w = board.shape
        block_steps = clamp_block_steps(rule, self.block_steps)
        # a copy even on the CPU: the runner's board is not the caller's array
        x = torch.from_numpy(np.ascontiguousarray(board, np.int8)).to(self.device, copy=True)
        spare = torch.empty_like(x) if x.is_cuda else None

        def advance(x, n):
            nonlocal spare
            out = int8_multi_step(x, rule, (h, w), n, block_steps=block_steps, scratch=spare)
            if x.is_cuda and out is not x:
                spare = x
            return out

        return DeviceRunner(x, advance, lambda x: x.cpu().numpy(), live_count_cells)

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
