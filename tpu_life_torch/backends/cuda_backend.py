"""The ``cuda`` backend: every deterministic rule on the card, through the
hand-written kernels where the TPU backend had one.

The counterpart of ``tpu_life/backends/pallas_backend.py``'s
``PallasBackend`` (``prepare``, ``_prepare_packed``, ``_make_runner``,
``_xla_scan_runner``), rebuilt for the GPU.  ``prepare`` routes in that
backend's order and records the route in the runner (``runner.route``):

- ``k1_diamond``: clamped 2-state von Neumann rules of radius <= 2 with
  ``bitpack`` on go through the diamond mode of kernel K1
  (``kernels.packed_stripe.packed_multi_step``), the depth clamped to
  ``32 // radius``;
- ``packed_torus`` and ``stencil``: every other von Neumann rule and every
  torus rule has no kernel in either package (the TPU backend sends them
  to its fused XLA scan) and runs the plain torch ops on the card,
  routed by ``torch_backend.plain_runner``: life-like torus rules on the
  packed words, the rest on the int8 board at its exact shape;
- ``k1``: clamped life-like rules with ``bitpack`` on (the default) go
  through the Moore mode of kernel K1 on the unframed ``pack_np`` words,
  int32[H, ceil(W/32)];
- ``k2``: every other clamped Moore rule — Generations, Larger-than-Life,
  and life-like rules with ``bitpack=False`` — goes through kernel K2
  (``kernels.int8_tiled.int8_multi_step``) on the unframed int8[H, W]
  board, its block depth clamped to the rule's radius as the TPU backend
  clamps it.

As the TPU backend, it takes no ``stencil``: ``--stencil`` is ignored here
(the kernels count with their own sums, the plain routes with shift-adds),
and continuous rules raise ``models.lenia.require_float_path``'s error, as
no kernel has a float path.

The kernels run at every board size: the TPU backend's small-board
fallback existed for Mosaic's alignment rules, which a CUDA kernel does
not have.  Each kernel loads zeros outside the board, so there is no frame
to pad or to re-zero.  Each advance of n steps is ``n // block_steps``
launches plus one remainder launch, ping-ponging two buffers allocated
once.  No route catches an error of another and carries on.

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
    plain_runner,
    to_words,
)
from tpu_life_torch.kernels.int8_tiled import clamp_block_steps, int8_multi_step
from tpu_life_torch.kernels.packed_stripe import MAX_BLOCK_STEPS, packed_multi_step
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.ops.stencil import live_count_cells

# substeps per kernel launch: device-memory traffic falls as 1/k while the
# halo recompute grows with k (K1: 2k rows per wavefront run or tile,
# packed_stripe.tile_rows)
DEFAULT_BLOCK_STEPS = 8


@register_backend("cuda")
class CudaBackend:
    name = "cuda"

    def __init__(
        self, *, device=None, block_steps: int | None = None, bitpack: bool = True, **_
    ):
        self.device = resolve_device(device)
        # as the TPU backend, any depth asked for runs, clamped to what the
        # kernels take (K2 clamps further by the rule's radius)
        self.block_steps = (
            DEFAULT_BLOCK_STEPS if block_steps is None
            else min(max(1, block_steps), MAX_BLOCK_STEPS)
        )
        self.bitpack = bitpack

    def prepare(self, board: np.ndarray, rule: Rule) -> DeviceRunner:
        if getattr(rule, "continuous", False):
            from tpu_life_torch.models.lenia import require_float_path

            require_float_path(rule, self.name)
        if self.bitpack and bitlife.supports_diamond(rule):
            return self._prepare_packed(board, rule, "k1_diamond")
        if rule.neighborhood != "moore" or rule.boundary != "clamped":
            # no kernel counts these: the plain ops are their executor
            return plain_runner(board, rule, self.device, self.bitpack)
        if self.bitpack and bitlife.supports(rule):
            return self._prepare_packed(board, rule, "k1")
        return self._prepare_int8(board, rule)

    def _prepare_packed(self, board: np.ndarray, rule: Rule, route: str) -> DeviceRunner:
        """Kernel K1 (the mode the rule selects) over the packed words."""
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
            x, advance, lambda x: from_words(x, w), bitlife.live_count_packed, route
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

        return DeviceRunner(x, advance, lambda x: x.cpu().numpy(), live_count_cells, "k2")

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
