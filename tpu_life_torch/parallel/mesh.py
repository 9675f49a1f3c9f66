"""The device mesh of the sharded backend (from ``tpu_life/parallel/mesh.py``).

A 1-D row mesh is an ordered tuple of ``torch.device``s, one per shard:
shard i holds the i-th stripe of board rows and exchanges halo rows with
shards i - 1 and i + 1.  A device may appear more than once, so one card
(or the CPU) can hold several shards: the counterpart of the JAX tests'
fake XLA devices, and how a one-card machine runs the same exchange and
per-shard code as a machine with one card per shard.

Not ported yet (ROADMAP A6): 2-D meshes and multi-process runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_life_torch.models.rules import NotPortedError

ROW_AXIS = "rows"


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of shard devices along the row axis."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def shape(self) -> dict[str, int]:
        return {ROW_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(num_devices: int | None = None, *, devices=None) -> Mesh:
    """A 1-D row mesh.

    With ``devices`` given, the mesh is those devices in order, repeats
    allowed (``[cuda:0] * 4`` puts four shards on one card); ``num_devices``
    then takes the first that many.  Without, it is the visible cards, one
    shard each: all of them, or the first ``num_devices``.  Asking for more
    devices than there are raises; the mesh never wraps around.
    """
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cards == 0:
            raise RuntimeError(
                "no CUDA device is available for a mesh of cards; pass "
                "devices (e.g. --device cpu --num-devices N puts N shards on the CPU)"
            )
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    devices = [torch.device(d) for d in devices]
    if num_devices is not None:
        if num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {num_devices}")
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, only {len(devices)} available"
            )
        devices = devices[:num_devices]
    for d in devices:
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"mesh devices must be cuda or cpu, got {d}")
    return Mesh(tuple(devices))


def make_mesh_2d(shape: tuple[int, int], *, devices=None) -> Mesh:
    """Rows x columns meshes are not ported yet."""
    raise NotPortedError(
        f"a 2-D mesh {tuple(shape)} is not yet ported to tpu_life_torch "
        f"(ROADMAP A6: K4 on 1-D and 2-D meshes with make_mesh_2d); use a "
        f"1-D row mesh"
    )


def init_distributed() -> None:
    """One process per card over NCCL is not ported yet."""
    raise NotPortedError(
        "multi-process runs are not yet ported to tpu_life_torch (ROADMAP "
        "A6: init_distributed with one process per card over NCCL); one "
        "process drives every shard of a mesh"
    )


def shard_height(height: int, n: int) -> int:
    """Rows of each of n shards of a board of ``height`` rows:
    ``ceil(height / n)``, the last shard padded with dead rows."""
    return -(-height // n)


def split_rows(board: np.ndarray, n: int) -> list[np.ndarray]:
    """The n row stripes of ``board`` (any dtype), each of
    :func:`shard_height` rows, the padding rows zero."""
    sh = shard_height(board.shape[0], n)
    padded = np.zeros((n * sh, *board.shape[1:]), board.dtype)
    padded[: board.shape[0]] = board
    return [padded[i * sh: (i + 1) * sh].copy() for i in range(n)]
