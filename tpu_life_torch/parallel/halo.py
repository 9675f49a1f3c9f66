"""Halo exchange between row shards and the plain per-shard run (from
``tpu_life/parallel/halo.py``).

A board of ``lh`` rows on a mesh of n shards is n chunks of ``hl =
ceil(lh / n)`` rows, chunk i holding global rows ``[i*hl, (i+1)*hl)`` (the
last one padded with dead rows).  One block advances every chunk ``k``
steps: :func:`exchange_rows` hands each shard the ``fr = r*k`` rows above
and below it from its neighbours (the ``ppermute`` pair of the JAX
package), then each shard steps its halo-extended chunk ``k`` times and
keeps the middle.  Clamped boards get zero halos at the mesh ends, which
is the dead boundary; the torus closes the ring.  Cells outside the board
are pinned dead after every step by the global row of each chunk row, so
padding rows never come alive.

:func:`make_shard_block` is the per-shard block in plain PyTorch ops: the
executor of the sharded backend's ``shard_ops`` route and the plain
version kernel K3 (``kernels/sharded_stripe.py``) is held to.
:func:`run_blocks` is the one epoch loop, whichever block steps the
shards.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.ops.stencil import make_masked_step, make_wrap_cols_step
from tpu_life_torch.parallel.mesh import Mesh

# block(top, chunk, bot, row0) -> the chunk advanced one block, where row0
# is the global row of top[0]
Block = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int], torch.Tensor]


def halo_depth(rule: Rule, block_steps: int) -> int:
    """Rows of halo needed to advance ``block_steps`` steps locally."""
    return rule.radius * block_steps


def on_device(device: torch.device):
    """Make ``device`` current for the launches and copies inside (a card
    of the mesh); nothing to do for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def halo_buffers(chunks: list[torch.Tensor], fr: int) -> tuple[list, list]:
    """Zeroed ``fr``-row halo tensors (tops, bots) beside each chunk, on its
    device.  The exchange writes all but the clamped mesh ends, which stay
    zero: the dead boundary."""
    tops = [torch.zeros((fr, c.shape[1]), dtype=c.dtype, device=c.device) for c in chunks]
    bots = [torch.zeros((fr, c.shape[1]), dtype=c.dtype, device=c.device) for c in chunks]
    return tops, bots


def exchange_rows(
    chunks: list[torch.Tensor],
    fr: int,
    *,
    periodic: bool,
    buffers: tuple[list, list] | None = None,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The halos of one block: ``tops[i]`` holds the last ``fr`` rows of
    chunk i - 1 and ``bots[i]`` the first ``fr`` rows of chunk i + 1.

    Clamped (``periodic=False``), the first shard's top and the last
    shard's bottom are zeros; ``periodic`` closes the ring, and one shard
    on a ring is its own neighbour (its own edge rows, no copy).  Every
    other halo is a copy into a preallocated tensor on the receiving
    shard's device (``buffers``, from :func:`halo_buffers`), even when
    both shards share a device, so a mesh on one card runs the same code
    as a mesh across cards.  A copy between two cards runs on the source
    card's current stream, ordered after the launch that wrote the
    source, and the receiving card's current stream waits for it
    (``Tensor.copy_`` between CUDA devices).  ``exchange_rows.copies``
    counts the copies: 2(n-1) per block clamped, 2n on a ring of n > 1.
    """
    n = len(chunks)
    hl = chunks[0].shape[0]
    if not 1 <= fr <= hl:
        raise ValueError(
            f"halo depth {fr} must be in [1, shard height {hl}]; lower "
            f"block_steps or use fewer shards"
        )
    if periodic and n == 1:
        return [chunks[0][hl - fr:]], [chunks[0][:fr]]
    tops, bots = buffers if buffers is not None else halo_buffers(chunks, fr)
    for i in range(n):
        if i > 0 or periodic:
            _copy(tops[i], chunks[i - 1][hl - fr:])
        if i < n - 1 or periodic:
            _copy(bots[i], chunks[(i + 1) % n][:fr])
    return tops, bots


exchange_rows.copies = 0


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    with on_device(dst.device):
        dst.copy_(src, non_blocking=True)
    exchange_rows.copies += 1


def make_shard_block(
    rule: Rule,
    logical_shape: tuple[int, int],
    block_steps: int,
    *,
    packed: bool,
    torus: bool = False,
) -> Block:
    """``block(top, chunk, bot, row0)``: ``block_steps`` steps of one
    shard in plain ops.  The chunk and its ``r * block_steps``-row halos
    are stacked, stepped ``block_steps`` times and the chunk's rows kept.

    Clamped, each step is the masked step with the global row of the
    stack's row 0 (``row0``), packed (``bitlife.make_masked_packed_step``:
    Moore or diamond by the rule) or int8 (``stencil.make_masked_step``).
    On the torus the halos are real rows, so nothing is masked by row:
    packed life-like rules take ``make_packed_torus_step(wrap_rows=False)``
    (columns wrap at the logical width, padding bits re-masked), the rest
    ``make_wrap_cols_step`` on the unpadded int8 board.
    """
    lh, lw = logical_shape
    fr = halo_depth(rule, block_steps)
    if torus:
        step = (
            bitlife.make_packed_torus_step(rule, lw, wrap_rows=False)
            if packed
            else make_wrap_cols_step(rule)
        )
        masked = lambda ext, row0: step(ext)  # noqa: E731
    elif packed:
        masked = bitlife.make_masked_packed_step(rule, (lh, lw))
    else:
        masked = make_masked_step(rule, (lh, lw))

    def block(top, chunk, bot, row0: int) -> torch.Tensor:
        if top.shape[0] != fr or bot.shape[0] != fr:
            raise ValueError(
                f"halos of {top.shape[0]} and {bot.shape[0]} rows, want "
                f"{fr} for {block_steps} steps of radius {rule.radius}"
            )
        ext = torch.cat([top, chunk, bot])
        for _ in range(block_steps):
            ext = masked(ext, row0)
        return ext[fr: fr + chunk.shape[0]]

    return block


def run_blocks(
    chunks: list[torch.Tensor],
    num_blocks: int,
    fr: int,
    block: Callable[..., torch.Tensor],
    *,
    periodic: bool,
    buffers: tuple[list, list] | None = None,
) -> list[torch.Tensor]:
    """The epoch loop: ``num_blocks`` times, one exchange of ``fr``-row
    halos and then ``block(i, top, chunk, bot, row0)`` on every shard i,
    which returns shard i's new chunk.  Shard i's ``row0`` is ``i * hl -
    fr``, the global row of its top halo's first row."""
    hl = chunks[0].shape[0]
    for _ in range(num_blocks):
        tops, bots = exchange_rows(chunks, fr, periodic=periodic, buffers=buffers)
        chunks = [
            block(i, top, chunk, bot, i * hl - fr)
            for i, (top, chunk, bot) in enumerate(zip(tops, chunks, bots))
        ]
    return chunks


def _make_run(rule, mesh: Mesh, logical_shape, block_steps: int, packed: bool, torus: bool):
    block = make_shard_block(rule, logical_shape, block_steps, packed=packed, torus=torus)
    fr = halo_depth(rule, block_steps)
    buffers: dict = {}

    def run(chunks: list[torch.Tensor], num_blocks: int) -> list[torch.Tensor]:
        if len(chunks) != mesh.size:
            raise ValueError(f"{len(chunks)} chunks for a mesh of {mesh.size}")
        if torus and len(chunks) * chunks[0].shape[0] != logical_shape[0]:
            raise ValueError(
                f"torus shards of {chunks[0].shape[0]} rows x {len(chunks)} "
                f"!= {logical_shape[0]} board rows: padding rows would sit "
                f"inside the glued seam"
            )
        if "halos" not in buffers:
            buffers["halos"] = halo_buffers(chunks, fr)
        return run_blocks(
            chunks, num_blocks, fr,
            lambda i, top, chunk, bot, row0: block(top, chunk, bot, row0),
            periodic=torus, buffers=buffers["halos"],
        )

    return run


def make_sharded_run(
    rule: Rule,
    mesh: Mesh,
    logical_shape: tuple[int, int],
    *,
    block_steps: int,
    packed: bool,
) -> Callable[[list[torch.Tensor], int], list[torch.Tensor]]:
    """``run(chunks, num_blocks)``: ``num_blocks * block_steps`` steps of a
    clamped board split in row chunks, one per mesh device, in plain ops;
    halos exchanged once per block."""
    return _make_run(rule, mesh, logical_shape, block_steps, packed, torus=False)


def make_sharded_run_torus(
    rule: Rule,
    mesh: Mesh,
    logical_shape: tuple[int, int],
    *,
    block_steps: int,
    packed: bool,
) -> Callable[[list[torch.Tensor], int], list[torch.Tensor]]:
    """The torus twin of :func:`make_sharded_run`: the ring is closed and
    each shard wraps its columns in place.  The chunks must hold the
    board's rows exactly (no padding rows inside the seam)."""
    return _make_run(rule, mesh, logical_shape, block_steps, packed, torus=True)
