"""The device mesh of the sharded backend (from ``tpu_life/parallel/mesh.py``).

A mesh is an ordered tuple of ``torch.device``s, one per shard, laid out
row-major over a grid of ``rows x cols`` shards: shard (i, j) is device
``i * cols + j`` and holds the (i, j)-th block of the board.  A 1-D row
mesh (:func:`make_mesh`) has one column: shard i holds the i-th stripe of
board rows and exchanges halo rows with shards i - 1 and i + 1.  A 2-D
mesh (:func:`make_mesh_2d`) also exchanges halo columns with the shards
left and right of it.  A device may appear more than once, so one card
(or the CPU) can hold several shards: the counterpart of the JAX tests'
fake XLA devices, and how a one-card machine runs the same exchange and
per-shard code as a machine with one card per shard.

Not ported yet (ROADMAP A6): multi-process runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_life_torch.backends.base import CudaUnavailableError
from tpu_life_torch.models.rules import NotPortedError
from tpu_life_torch.utils.padding import ceil_div

ROW_AXIS = "rows"
COL_AXIS = "cols"


@dataclass(frozen=True)
class Mesh:
    """Shard devices in row-major order over ``rows x cols`` shards;
    ``cols`` is None for a 1-D row mesh."""

    devices: tuple[torch.device, ...]
    cols: int | None = None

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if self.cols is not None and (self.cols < 1 or len(self.devices) % self.cols):
            raise ValueError(f"{len(self.devices)} devices do not fill rows of {self.cols} columns")

    @property
    def n_cols(self) -> int:
        return self.cols or 1

    @property
    def n_rows(self) -> int:
        return len(self.devices) // self.n_cols

    @property
    def shape(self) -> dict[str, int]:
        if self.cols is None:
            return {ROW_AXIS: len(self.devices)}
        return {ROW_AXIS: self.n_rows, COL_AXIS: self.cols}

    @property
    def size(self) -> int:
        return len(self.devices)


def _devices(devices) -> list[torch.device]:
    """``devices`` as torch devices, or the visible cards when None."""
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cards == 0:
            raise CudaUnavailableError(
                "no CUDA device is available for a mesh of cards; pass "
                "devices (e.g. --device cpu --num-devices N puts N shards on the CPU)"
            )
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"mesh devices must be cuda or cpu, got {d}")
    return devices


def make_mesh(num_devices: int | None = None, *, devices=None) -> Mesh:
    """A 1-D row mesh.

    With ``devices`` given, the mesh is those devices in order, repeats
    allowed (``[cuda:0] * 4`` puts four shards on one card); ``num_devices``
    then takes the first that many.  Without, it is the visible cards, one
    shard each: all of them, or the first ``num_devices``.  Asking for more
    devices than there are raises; the mesh never wraps around.
    """
    devices = _devices(devices)
    if num_devices is not None:
        if num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {num_devices}")
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, only {len(devices)} available"
            )
        devices = devices[:num_devices]
    return Mesh(tuple(devices))


def make_mesh_2d(shape: tuple[int, int], *, devices=None) -> Mesh:
    """A ``rows x cols`` mesh over the first ``rows * cols`` of ``devices``
    (repeats allowed, as in :func:`make_mesh`) or of the visible cards.
    Per block a shard exchanges halos with the shards above and below it,
    then the row-extended edge columns with those left and right of it, so
    halo traffic follows the shard's perimeter rather than the board's
    width."""
    r, c = (int(v) for v in shape)
    if r < 1 or c < 1:
        raise ValueError(f"mesh shape must be two positive ints, got {tuple(shape)}")
    devices = _devices(devices)
    if r * c > len(devices):
        raise ValueError(
            f"mesh shape {(r, c)} needs {r * c} devices, only {len(devices)} available"
        )
    return Mesh(tuple(devices[: r * c]), cols=c)


def init_distributed() -> None:
    """One process per card over NCCL is not ported yet."""
    raise NotPortedError(
        "multi-process runs are not yet ported to tpu_life_torch (ROADMAP "
        "A6: init_distributed with one process per card over NCCL); one "
        "process drives every shard of a mesh"
    )


def shard_extent(extent: int, n: int, minimum: int = 1) -> int:
    """Rows (or columns) of each of n shards of a board ``extent`` long:
    ``ceil(extent / n)``, and at least ``minimum`` (a clamped board's
    shards are at least a radius deep, so every halo comes from the next
    shard alone); the last shards are padded with dead cells."""
    return max(ceil_div(extent, n), minimum)


def split_blocks(
    board: np.ndarray, grid: tuple[int, int], block: tuple[int, int]
) -> list[np.ndarray]:
    """The ``grid[0] x grid[1]`` blocks of ``block`` cells (or words) of
    ``board`` (any dtype), in row-major order; what lies past the board is
    zero."""
    (r, c), (bh, bw) = grid, block
    if r * bh < board.shape[0] or c * bw < board.shape[1]:
        raise ValueError(f"{r}x{c} blocks of {bh}x{bw} do not cover a board of {board.shape}")
    padded = np.zeros((r * bh, c * bw), board.dtype)
    padded[: board.shape[0], : board.shape[1]] = board
    return [padded[i * bh: (i + 1) * bh, j * bw: (j + 1) * bw].copy()
            for i in range(r) for j in range(c)]


def gather_blocks(
    blocks: list[np.ndarray], grid: tuple[int, int], shape: tuple[int, int]
) -> np.ndarray:
    """The board of :func:`split_blocks`: the blocks joined in row-major
    order and cut to ``shape``."""
    r, c = grid
    rows = [np.concatenate(blocks[i * c: (i + 1) * c], axis=1) for i in range(r)]
    return np.concatenate(rows)[: shape[0], : shape[1]]


def split_rows(board: np.ndarray, n: int, rows: int | None = None) -> list[np.ndarray]:
    """The n row stripes of ``board`` (any dtype), each of ``rows`` rows
    (default :func:`shard_extent`), the padding rows zero."""
    rows = shard_extent(board.shape[0], n) if rows is None else rows
    return split_blocks(board, (n, 1), (rows, board.shape[1]))
