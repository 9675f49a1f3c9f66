"""The ``torch`` backend: every deterministic rule in plain PyTorch ops.

The counterpart of ``tpu_life/backends/jax_backend.py`` (``DeviceRunner``,
``packed_device_runner``, ``JaxBackend.prepare``).  :func:`plain_runner`
decides the route in the JAX backend's order: with ``bitpack`` on, clamped
life-like rules, clamped 2-state von Neumann rules of radius <= 2 and
life-like torus rules run bit-sliced on int32 words in the ``pack_np``
layout (``ops.bitlife``); every other rule, and every rule with
``bitpack`` off, runs the int8 stencil (``ops.stencil.make_step``) on the
board at its exact shape, which is what a torus needs.  The ``cuda``
backend hands the rules it has no kernel for to the same function, so one
place decides them.  ``DeviceRunner`` serves both backends, over packed
words or int8 boards, and names the route it was built for.

The ``torch`` backend's ``stencil`` (``--stencil auto|roll|matmul``)
resolves per rule by ``ops.conv.resolve_stencil``: under ``auto`` matmul
for continuous rules, and for integer rules only from the crossover
radius a deployment sets.  A matmul rule
takes the int8 route with its counts by banded matmuls, bit-identical,
and skips the bit-sliced routes; continuous rules run the float Lenia
runner (``models.lenia.LeniaDeviceRunner``).
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
from tpu_life_torch.obs import profiler_span
from tpu_life_torch.ops import bitlife
from tpu_life_torch.ops.conv import resolve_stencil, validate_stencil
from tpu_life_torch.ops.stencil import live_count_cells, make_step


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
    host and ``count_live`` reduces its live cells on the device.
    ``advance``, ``sync`` (its wait and its read-back) and ``snapshot``'s
    copy are spans of a ``torch.profiler`` trace (``obs.profiler_span``).
    ``route`` names the executor ``advance`` runs: a kernel (``k1``,
    ``k1_diamond``, ``k2``) or plain ops (``packed``, ``packed_diamond``,
    ``packed_torus``, ``stencil``); ``stencil`` names how the ``stencil``
    route counts (``roll`` or ``matmul``)."""

    def __init__(
        self,
        x: torch.Tensor,
        advance: Callable[[torch.Tensor, int], torch.Tensor],
        to_np: Callable[[torch.Tensor], np.ndarray],
        count_live: Callable[[torch.Tensor], torch.Tensor],
        route: str = "",
        stencil: str = "roll",
    ):
        self.x = x
        self._advance = advance
        self._to_np = to_np
        self._count_live = count_live
        self.route = route
        self.stencil = stencil

    def advance(self, steps: int) -> None:
        with profiler_span("runner.advance"):
            if steps > 0:
                self.x = self._advance(self.x, steps)

    def sync(self) -> None:
        with profiler_span("runner.sync"):
            with profiler_span("runner.sync.wait"):
                if self.x.is_cuda:
                    torch.cuda.synchronize(self.x.device)
            with profiler_span("runner.sync.readback"):
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
        with profiler_span("runner.snapshot"):
            x = self.x.clone()
        return lambda x=x: self._to_np(x)


class ShardedRunner:
    """Runner over a board split into blocks on a ``rows x cols`` mesh (the
    ``sharded`` backend): ``chunks`` are the tensors of the shards this
    process holds, ``shard_ids`` their row-major indices on the mesh (all
    of them on one process), each chunk ``block`` rows by words or cells.
    ``advance`` queues each block's halo exchange and per-shard steps with
    no host round-trip; ``sync`` waits for this process's cards;
    ``gather`` joins the chunks on the first shard's device and drops the
    padding rows and columns (``shape``: the board's rows and its words
    or cells), which only a process that holds every shard can do;
    ``live_count`` sums the shards' counts over every process.  ``route``
    names the per-shard executor: kernel K3 (``k3``, ``k3_diamond``,
    ``k3_torus``), kernel K4 (``k4``) or plain ops (``shard_ops``)."""

    def __init__(
        self,
        chunks: list[torch.Tensor],
        advance: Callable[[list[torch.Tensor], int], list[torch.Tensor]],
        to_np: Callable[[torch.Tensor], np.ndarray],
        count_live: Callable[[torch.Tensor], torch.Tensor],
        route: str,
        grid: tuple[int, int],
        shape: tuple[int, int],
        *,
        shard_ids: list[int],
        block: tuple[int, int],
    ):
        self.chunks = chunks
        self._advance = advance
        self._to_np = to_np
        self._count_live = count_live
        self.route = route
        self.grid = grid
        self.shape = shape
        self.shard_ids = list(shard_ids)
        self.block = block

    def advance(self, steps: int) -> None:
        if steps > 0:
            self.chunks = self._advance(self.chunks, steps)

    def sync(self) -> None:
        for device in {c.device for c in self.chunks if c.is_cuda}:
            torch.cuda.synchronize(device)
        self.chunks[-1][:1, :1].cpu()

    def gather(self, chunks: list[torch.Tensor] | None = None) -> torch.Tensor:
        """The board (words or cells) on the first shard's device, from
        ``chunks`` (default: the current ones)."""
        chunks = self.chunks if chunks is None else chunks
        if len(chunks) != self.grid[0] * self.grid[1]:
            raise ValueError(
                f"this process holds {len(chunks)} of the mesh's "
                f"{self.grid[0] * self.grid[1]} shards and cannot gather the board; a run "
                f"across processes writes its output per shard (--stream-io)"
            )
        first = chunks[0].device
        cols = self.grid[1]
        rows = [torch.cat([c.to(first) for c in chunks[i: i + cols]], dim=1)
                for i in range(0, len(chunks), cols)]
        h, w = self.shape
        return torch.cat(rows)[:h, :w].contiguous()

    def fetch(self) -> np.ndarray:
        return self._to_np(self.gather())

    def live_count(self) -> int:
        """Exact live-cell count: one scalar per shard, reduced on its
        device (padding rows and columns are dead), then summed over the
        processes of the job."""
        from tpu_life_torch.parallel.mesh import all_reduce_sum, process_count

        counts = [self._count_live(c) for c in self.chunks]
        if process_count() == 1:
            return sum(int(c) for c in counts)
        return all_reduce_sum(sum(c.to(counts[0].device) for c in counts))

    def snapshot(self) -> Callable[[], np.ndarray]:
        """Thunk over device copies of the current chunks."""
        return lambda chunks=[c.clone() for c in self.chunks]: self._to_np(self.gather(chunks))


def packed_device_runner(
    board: np.ndarray, device: torch.device, advance, route: str
) -> DeviceRunner:
    """DeviceRunner over the packed board."""
    w = board.shape[1]
    return DeviceRunner(
        to_words(board, device), advance, lambda x: from_words(x, w),
        bitlife.live_count_packed, route,
    )


def plain_runner(
    board: np.ndarray, rule: Rule, device: torch.device, bitpack: bool = True,
    stencil: str = "roll",
) -> DeviceRunner:
    """The plain-ops runner of ``rule``, routed as ``JaxBackend.prepare``
    routes it: packed Moore, packed diamond, packed torus, else the int8
    stencil on the unpadded board, counting by ``stencil``.  A ``matmul``
    stencil takes the int8 route whatever ``bitpack`` says."""
    h, w = board.shape
    bitpack = bitpack and stencil != "matmul"
    if bitpack and bitlife.supports(rule):
        return packed_device_runner(
            board, device,
            lambda x, n: bitlife.multi_step_packed(x, rule=rule, steps=n, logical_shape=(h, w)),
            "packed",
        )
    if bitpack and bitlife.supports_diamond(rule):
        return packed_device_runner(
            board, device,
            lambda x, n: bitlife.multi_step_packed_diamond(
                x, rule=rule, steps=n, logical_shape=(h, w)
            ),
            "packed_diamond",
        )
    if bitpack and bitlife.supports_torus(rule):
        return packed_device_runner(
            board, device,
            lambda x, n: bitlife.multi_step_packed_torus(x, rule=rule, steps=n, width=w),
            "packed_torus",
        )
    # the board at its exact shape: nothing to mask on a clamped board, and
    # on a torus padding would sit between the edges it glues together.  A
    # copy even on the CPU: the runner's board is not the caller's array
    x = torch.from_numpy(np.ascontiguousarray(board, np.int8)).to(device, copy=True)
    step = make_step(rule, stencil, (h, w))

    def advance(x, n):
        for _ in range(n):
            x = step(x)
        return x

    return DeviceRunner(
        x, advance, lambda x: x.cpu().numpy(), live_count_cells, "stencil", stencil
    )


@register_backend("torch")
class TorchBackend:
    name = "torch"

    def __init__(self, *, device=None, bitpack: bool = True, stencil: str = "auto", **_):
        self.device = resolve_device(device)
        self.bitpack = bitpack
        self.stencil = validate_stencil(stencil)

    def prepare(self, board: np.ndarray, rule: Rule):
        stencil = resolve_stencil(rule, self.stencil, self.name)
        if getattr(rule, "continuous", False):
            from tpu_life_torch.models.lenia import LeniaDeviceRunner

            return LeniaDeviceRunner(board, rule, stencil=stencil, device=self.device)
        return plain_runner(board, rule, self.device, self.bitpack, stencil)

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
