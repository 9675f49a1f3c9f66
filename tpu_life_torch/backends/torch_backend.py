"""The ``torch`` backend: the plain PyTorch bit-sliced step on one device.

The counterpart of ``tpu_life/backends/jax_backend.py``'s packed path
(``DeviceRunner``, ``packed_device_runner``): the board lives on the
device as int32 words in the ``pack_np`` layout, and ``advance`` runs
``ops.bitlife.multi_step_packed`` there.  It is the plain version the
``cuda`` backend's kernel is held to, on any explicit device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tpu_life_torch.backends.base import (
    ChunkCallback,
    register_backend,
    resolve_device,
    run_with_runner,
)
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops import bitlife


def require_life_like(rule: Rule, backend: str) -> None:
    """Raise the typed ``NotImplementedError`` for every rule the packed
    path does not run yet, naming where it is queued."""
    if bitlife.supports(rule):
        return
    if rule.boundary == "torus":
        what = "the packed torus step (':T' rules)"
    elif rule.neighborhood == "von_neumann":
        what = "von Neumann rules (the diamond mode of the packed stripe kernel, or the int8 kernel K2)"
    else:
        what = "Generations and Larger-than-Life rules (the int8 tiled kernel K2)"
    raise NotImplementedError(
        f"rule {rule.name!r} is not yet ported to the {backend} backend, which "
        f"runs clamped life-like rules only; {what} is queued as ROADMAP.md "
        f"item A5 (slice 2).  Use --backend numpy for it."
    )


def to_words(board: np.ndarray, device: torch.device) -> torch.Tensor:
    """int8[H, W] board -> int32[H, ceil(W/32)] packed words on ``device``."""
    packed = bitlife.pack_np(np.asarray(board, np.int8))
    return torch.from_numpy(packed.view(np.int32)).to(device)


def from_words(x: torch.Tensor, width: int) -> np.ndarray:
    """int32 packed words (any device) -> int8[H, width] host board."""
    words = x.cpu().numpy().view(np.uint32)
    return bitlife.unpack_np(words, width)


class DeviceRunner:
    """Runner over a device-resident packed board: ``advance`` queues work
    with no host round-trip; ``sync`` waits for the card and reads one
    element back."""

    def __init__(self, x: torch.Tensor, advance: Callable, width: int):
        self.x = x
        self._advance = advance
        self.width = width

    def advance(self, steps: int) -> None:
        if steps > 0:
            self.x = self._advance(self.x, steps)

    def sync(self) -> None:
        if self.x.is_cuda:
            torch.cuda.synchronize(self.x.device)
        self.x[:1, :1].cpu()

    def fetch(self) -> np.ndarray:
        return from_words(self.x, self.width)

    def live_count(self) -> int:
        """Exact live-cell count, reduced on the device; one scalar
        crosses to the host."""
        return int(bitlife.live_count_packed(self.x))

    def snapshot(self) -> Callable[[], np.ndarray]:
        """Thunk over a device copy of the current board: later advances
        (which may reuse the current buffer) leave it unchanged, like the
        reference Runner's immutable snapshots."""
        return lambda x=self.x.clone(): from_words(x, self.width)


def packed_device_runner(
    board: np.ndarray, rule: Rule, device: torch.device, advance=None
) -> DeviceRunner:
    """DeviceRunner over the packed board; ``advance`` defaults to the
    plain masked multi-step."""
    h, w = board.shape
    if advance is None:
        advance = lambda x, n: bitlife.multi_step_packed(
            x, rule=rule, steps=n, logical_shape=(h, w)
        )
    return DeviceRunner(to_words(board, device), advance, w)


@register_backend("torch")
class TorchBackend:
    name = "torch"

    def __init__(self, *, device=None, **_):
        self.device = resolve_device(device)

    def prepare(self, board: np.ndarray, rule: Rule) -> DeviceRunner:
        require_life_like(rule, self.name)
        return packed_device_runner(board, rule, self.device)

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
