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

A run may span several processes (:func:`init_distributed`, the
reference's one MPI rank per stripe): the global mesh is then every
process's local devices in rank order, ``Mesh.ranks`` names the process
that owns each shard, and a process holds and steps only its own shards.
The transport is chosen from the device: ``nccl`` for shards on cards,
``gloo`` for shards on the CPU.
"""

from __future__ import annotations

import atexit
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from tpu_life_torch.backends.base import CudaUnavailableError
from tpu_life_torch.utils.padding import ceil_div

ROW_AXIS = "rows"
COL_AXIS = "cols"


@dataclass(frozen=True)
class Mesh:
    """Shard devices in row-major order over ``rows x cols`` shards;
    ``cols`` is None for a 1-D row mesh."""

    devices: tuple[torch.device, ...]
    cols: int | None = None
    # the process that owns each shard, None when one process owns them
    # all; ``devices[s]`` is shard s's device on its owner
    ranks: tuple[int, ...] | None = None

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if self.cols is not None and (self.cols < 1 or len(self.devices) % self.cols):
            raise ValueError(f"{len(self.devices)} devices do not fill rows of {self.cols} columns")
        if self.ranks is not None and len(self.ranks) != len(self.devices):
            raise ValueError(f"{len(self.ranks)} owner ranks for {len(self.devices)} shards")

    def is_local(self, s: int) -> bool:
        """Whether this process owns shard s."""
        return self.ranks is None or self.ranks[s] == process_index()

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


def make_mesh(num_devices: int | None = None, *, devices=None, ranks=None) -> Mesh:
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
    return Mesh(tuple(devices), ranks=_owners(ranks, len(devices)))


def make_mesh_2d(shape: tuple[int, int], *, devices=None, ranks=None) -> Mesh:
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
    return Mesh(tuple(devices[: r * c]), cols=c, ranks=_owners(ranks, r * c))


def _owners(ranks, n: int) -> tuple[int, ...] | None:
    if ranks is None:
        return None
    ranks = tuple(int(q) for q in ranks)
    if len(ranks) < n:
        raise ValueError(f"{len(ranks)} owner ranks for a mesh of {n} shards")
    return ranks[:n]


# -- several processes -------------------------------------------------------

_initialized = False  # init_distributed started the process group


def init_distributed(device=None) -> None:
    """Join a multi-process job if the environment describes one: the
    analogue of ``MPI_Init`` (Parallel_Life_MPI.cpp:195) and of the JAX
    package's ``init_distributed``.

    The job is the JAX package's triple (``JAX_COORDINATOR_ADDRESS`` or
    ``COORDINATOR_ADDRESS``, then ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``), so one launcher drives either package, or
    torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``.  The transport follows ``device`` (the run's ``--device``):
    ``gloo`` for the CPU, ``nccl`` for the cards (the default), and then
    this process's card is made current: ``device``'s index, else
    ``LOCAL_RANK``, else the rank modulo the visible cards.  With no job in
    the environment this is a no-op; it is idempotent, as the driver calls
    it on every run, and the process group is destroyed at exit.
    """
    global _initialized
    if _initialized or dist.is_initialized():
        return
    spec = _job_from_env()
    if spec is None:
        return
    init_method, world, rank = spec
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        backend = "gloo"
    elif dev.type == "cuda":
        if not torch.cuda.is_available():
            raise CudaUnavailableError(
                "a multi-process job on the cards needs a CUDA device; pass "
                "--device cpu to run its shards on the CPU over gloo"
            )
        backend = "nccl"
        torch.cuda.set_device(local_card(rank) if dev.index is None else dev)
    else:
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _initialized = True
    atexit.register(_shutdown)


def _job_from_env() -> tuple[str, int, int] | None:
    """(init method, processes, this process's rank) from the environment,
    or None when it describes no job.  torchrun's job joins by ``env://``,
    which finds the store torchrun's agent already serves."""
    env = os.environ
    addr = env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS")
    if addr:
        num = env.get("JAX_NUM_PROCESSES")
        if num is not None:
            pid = env.get("JAX_PROCESS_ID")
            if pid is None:
                raise RuntimeError(
                    "incomplete distributed process spec: JAX_NUM_PROCESSES "
                    "is set but JAX_PROCESS_ID is not (the explicit triple is "
                    "JAX_COORDINATOR_ADDRESS + JAX_NUM_PROCESSES + "
                    "JAX_PROCESS_ID)"
                )
            return f"tcp://{addr}", int(num), int(pid)
        if env.get("WORLD_SIZE") is not None and env.get("RANK") is not None:
            return f"tcp://{addr}", int(env["WORLD_SIZE"]), int(env["RANK"])
        raise RuntimeError(
            "incomplete distributed process spec: a coordinator address is set "
            "but no process count; set JAX_NUM_PROCESSES and JAX_PROCESS_ID "
            "(or torchrun's WORLD_SIZE and RANK)"
        )
    if env.get("MASTER_ADDR") and env.get("MASTER_PORT") and env.get("WORLD_SIZE"):
        if env.get("RANK") is None:
            raise RuntimeError(
                "incomplete distributed process spec: WORLD_SIZE is set but RANK "
                "is not (torchrun sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)"
            )
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    return None


def local_card(rank: int) -> torch.device:
    """This process's card in a job of one process per card:
    ``LOCAL_RANK`` (torchrun) or the rank modulo the visible cards."""
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def _shutdown() -> None:
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def process_count() -> int:
    """Processes in the job (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a job)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_lead() -> bool:
    """Whether this process owns the single-writer side effects: the
    reference's rank 0 (Parallel_Life_MPI.cpp:234-236)."""
    return process_index() == 0


def process_devices(local: list[torch.device]) -> tuple[list[torch.device], list[int]]:
    """The global mesh's devices and owner ranks: every process's local
    devices in rank order.  Each process brings as many as this one; it
    names the others' by its own, as it never touches them."""
    world = process_count()
    return list(local) * world, [q for q in range(world) for _ in local]


def all_reduce_sum(x: torch.Tensor) -> int:
    """The sum of a scalar over every process (``x`` on this process's
    transport device: the card under nccl, the CPU under gloo)."""
    if process_count() > 1:
        x = x.clone()
        dist.all_reduce(x)
    return int(x)


def barrier() -> None:
    """Wait for every process of the job (nothing to wait for alone)."""
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


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
