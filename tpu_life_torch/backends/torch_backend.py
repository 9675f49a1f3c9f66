"""The ``torch`` backend: the plain PyTorch bit-sliced step on one device.

The counterpart of ``tpu_life/backends/jax_backend.py``'s packed path
(``DeviceRunner``, ``packed_device_runner``): the board lives on the
device as int32 words in the ``pack_np`` layout, and ``advance`` runs
``ops.bitlife.multi_step_packed`` there.  It runs clamped life-like rules
only; the ``cuda`` backend runs the rest of the clamped Moore rules.
``DeviceRunner`` serves both backends, over packed words or int8 boards.
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


def require_clamped_moore(rule: Rule, backend: str) -> None:
    """Raise the typed ``NotImplementedError`` for the rules no backend of
    this package runs on the card yet, naming where they are queued."""
    if rule.boundary == "torus":
        what = "the packed and int8 torus steps (':T' rules)"
    elif rule.neighborhood == "von_neumann":
        what = (
            "von Neumann rules (the diamond mode of the packed stripe kernel "
            "K1 and the int8 von Neumann path)"
        )
    else:
        return
    raise NotImplementedError(
        f"rule {rule.name!r} is not yet ported to the {backend} backend; "
        f"{what} are queued as ROADMAP.md item A5b (the next slice of the "
        f"port).  Use --backend numpy for it."
    )


def require_life_like(rule: Rule, backend: str) -> None:
    """Raise the typed ``NotImplementedError`` for every rule the packed
    path does not run."""
    require_clamped_moore(rule, backend)
    if bitlife.supports(rule):
        return
    raise NotImplementedError(
        f"rule {rule.name!r} does not run on the {backend} backend, which "
        f"runs clamped life-like rules only (ROADMAP.md A5 keeps it so).  "
        f"Generations and Larger-than-Life rules run on the cuda backend "
        f"through the int8 tiled kernel K2 (add --device cpu for its plain "
        f"version on the CPU), or on --backend numpy."
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
    """Runner over a device-resident board (packed words or int8 cells):
    ``advance`` queues work with no host round-trip; ``sync`` waits for the
    card and reads one element back; ``to_np`` gathers the board to the
    host and ``count_live`` reduces its live cells on the device."""

    def __init__(
        self,
        x: torch.Tensor,
        advance: Callable[[torch.Tensor, int], torch.Tensor],
        to_np: Callable[[torch.Tensor], np.ndarray],
        count_live: Callable[[torch.Tensor], torch.Tensor],
    ):
        self.x = x
        self._advance = advance
        self._to_np = to_np
        self._count_live = count_live

    def advance(self, steps: int) -> None:
        if steps > 0:
            self.x = self._advance(self.x, steps)

    def sync(self) -> None:
        if self.x.is_cuda:
            torch.cuda.synchronize(self.x.device)
        self.x[:1, :1].cpu()

    def fetch(self) -> np.ndarray:
        return self._to_np(self.x)

    def live_count(self) -> int:
        """Exact live-cell count, reduced on the device; one scalar
        crosses to the host."""
        return int(self._count_live(self.x))

    def snapshot(self) -> Callable[[], np.ndarray]:
        """Thunk over a device copy of the current board: later advances
        (which may reuse the current buffer) leave it unchanged, like the
        reference Runner's immutable snapshots."""
        return lambda x=self.x.clone(): self._to_np(x)


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
    return DeviceRunner(
        to_words(board, device), advance, lambda x: from_words(x, w),
        bitlife.live_count_packed,
    )


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
