"""Halo exchange between shards and the plain per-shard run (from
``tpu_life/parallel/halo.py``).

A board of ``lh x lw`` on a mesh of ``R x C`` shards is R*C chunks of
``hl x wl``, a row-major list: chunk (i, j) holds board rows ``[i*hl,
(i+1)*hl)`` and columns ``[j*wl, (j+1)*wl)`` (cells, or words of 32 cells
on packed boards), the last chunks padded with dead rows and columns.  A
1-D row mesh is the case C = 1, whose chunks span the board's width.  One
block advances every chunk ``k`` steps:

1. :func:`exchange_rows` hands each shard the ``fr = r*k`` rows above and
   below it from its neighbours in its mesh column (the ``ppermute`` pair
   of the JAX package);
2. on a mesh of more than one column, :func:`exchange_cols` then hands it
   the ``fc`` edge columns of the row-extended chunks left and right of it
   (``fr + hl + fr`` rows: the neighbour's top halo, chunk and bottom
   halo), so the corner cells ride this second exchange transitively, as
   in the JAX package's ``make_sharded_run_2d``.  ``fc`` is ``r*k`` cells,
   or ``ceil(r*k / 32)`` words on packed boards;
3. each shard steps its halo-extended chunk ``k`` times and keeps the
   middle.

Clamped boards get zero halos at the mesh ends, which is the dead
boundary; the torus closes the rings.

On a mesh that spans several processes (``Mesh.ranks``, from
``mesh.init_distributed``) the chunk list is the global one with None in
the place of each shard another process owns.  A halo between two shards
of this process is a copy, as on one process; a halo from or to another
process is a ``torch.distributed`` send or receive, posted with those of
the whole exchange as one ``batch_isend_irecv``, the reference's
``MPI_Sendrecv`` of ghost rows (Parallel_Life_MPI.cpp:104-145).  Every
process walks the same global list of transfers, so the sends and the
receives between two processes pair up in order.

Cells outside the board are pinned dead after every step by the board
coordinates of each chunk cell, so padding never comes alive.

:func:`make_shard_block` is the per-shard block in plain PyTorch ops: the
executor of the sharded backend's ``shard_ops`` route and the plain
version kernels K3 (``kernels/sharded_stripe.py``) and K4
(``kernels/sharded_int8.py``) are held to.  :func:`run_blocks` is the one
epoch loop, whichever block steps the shards.
"""

from __future__ import annotations

import contextlib
from dataclasses import replace
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.ops.stencil import make_masked_step, make_step, make_wrap_cols_step
from tpu_life_torch.parallel.mesh import Mesh
from tpu_life_torch.utils.padding import ceil_div


class Halos(NamedTuple):
    """A shard's halos for one block: ``top``/``bot`` of ``fr`` rows and
    the chunk's width; ``left``/``right`` of ``fr + hl + fr`` rows and
    ``fc`` columns (corners included), None where the mesh has no column
    exchange."""

    top: torch.Tensor
    bot: torch.Tensor
    left: torch.Tensor | None = None
    right: torch.Tensor | None = None


# block(i, chunk, halos, row0, col0) -> shard i's chunk advanced one block,
# where (row0, col0) is the board coordinate of the halo-extended chunk's
# cell (0, 0): row0 that of top[0], col0 that of left[0, 0] (of chunk[0, 0]
# without column halos); in words on packed boards
Block = Callable[[int, torch.Tensor, Halos, int, int], torch.Tensor]


def halo_depth(rule: Rule, block_steps: int) -> int:
    """Rows of halo needed to advance ``block_steps`` steps locally."""
    return rule.radius * block_steps


def col_halo_width(rule: Rule, block_steps: int, packed: bool) -> int:
    """Columns of halo for ``block_steps`` steps: the reach in cells, or
    the whole words that hold it on packed boards (a word's carries move
    one cell a step, so ``ceil(r*k / 32)`` words hold the cells a block
    needs)."""
    reach = halo_depth(rule, block_steps)
    return ceil_div(reach, bitlife.WORD) if packed else reach


def get_clamped_twin(rule: Rule) -> Rule:
    """The same rule with a clamped boundary: the 2-D torus's local step
    is boundary-free (the halos carry the wrap), so it runs the plain
    clamped step unmasked."""
    return replace(rule, boundary="clamped")


def on_device(device: torch.device):
    """Make ``device`` current for the launches and copies inside (a card
    of the mesh); nothing to do for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _zeros(chunks: list, shape) -> list:
    """A zeroed tensor of ``shape(chunk)`` beside each chunk, on its
    device (None beside another process's shard)."""
    return [None if c is None else torch.zeros(shape(c), dtype=c.dtype, device=c.device)
            for c in chunks]


def halo_buffers(chunks: list[torch.Tensor], fr: int) -> tuple[list, list]:
    """Zeroed ``fr``-row halo tensors (tops, bots) beside each chunk, on its
    device.  The exchange writes all but the clamped mesh ends, which stay
    zero: the dead boundary."""
    shape = lambda c: (fr, c.shape[1])  # noqa: E731
    return _zeros(chunks, shape), _zeros(chunks, shape)


def col_buffers(chunks: list[torch.Tensor], fr: int, fc: int) -> tuple[list, list]:
    """Zeroed column halo tensors (lefts, rights) of ``fr + hl + fr`` rows
    and ``fc`` columns beside each chunk, on its device; the clamped mesh
    ends stay zero."""
    shape = lambda c: (c.shape[0] + 2 * fr, fc)  # noqa: E731
    return _zeros(chunks, shape), _zeros(chunks, shape)


def _first(chunks: list) -> torch.Tensor:
    """A chunk this process holds (every chunk has its shape)."""
    return next(c for c in chunks if c is not None)


class _Transfers:
    """The halos of one exchange, in the global order every process walks:
    a copy where this process holds both shards, a send or a receive where
    it holds one (posted together by :meth:`finish`), nothing where it
    holds neither.  ``ranks`` names each shard's process."""

    def __init__(self, counter, ranks):
        self.counter = counter
        self.ranks = ranks
        self.ops: list = []
        self.tag = 0

    def move(self, dst: torch.Tensor | None, s: int, src: list | None, t: int) -> None:
        """Shard t's pieces ``src`` (``(rows of dst, view)`` pairs, stacked
        in order; rows None for the whole of ``dst``) into shard s's halo
        ``dst``; each side is None where another process holds that
        shard."""
        self.tag += 1
        if dst is not None and src is not None:
            for rows, view in src:
                _copy(dst if rows is None else dst[rows], view, self.counter)
        elif dst is not None:
            self.ops.append(dist.P2POp(dist.irecv, dst, self.ranks[t], tag=self.tag))
        elif src is not None:
            views = [view for _, view in src]
            send = views[0].contiguous() if len(views) == 1 else torch.cat(views)
            self.ops.append(dist.P2POp(dist.isend, send, self.ranks[s], tag=self.tag))
            self.counter.sends += 1

    def finish(self) -> None:
        """Post the sends and receives as one batch and wait for them: on
        the cards ``wait`` orders the current stream after the transfer,
        before the next launch."""
        if self.ops:
            for work in dist.batch_isend_irecv(self.ops):
                work.wait()


def exchange_rows(
    chunks: list[torch.Tensor],
    fr: int,
    *,
    periodic: bool,
    buffers: tuple[list, list] | None = None,
    cols: int = 1,
    ranks: tuple[int, ...] | None = None,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The row halos of one block on a mesh of ``cols`` columns (chunks in
    row-major order): ``tops[s]`` holds the last ``fr`` rows of the chunk
    above shard s in its mesh column and ``bots[s]`` the first ``fr`` rows
    of the chunk below it.

    Clamped (``periodic=False``), the first mesh row's tops and the last
    mesh row's bottoms are zeros; ``periodic`` closes the rings, and a mesh
    of one row is its own neighbour (each chunk's own edge rows, no copy).
    Every other halo is a copy into a preallocated tensor on the receiving
    shard's device (``buffers``, from :func:`halo_buffers`), even when
    both shards share a device, so a mesh on one card runs the same code
    as a mesh across cards.  A copy between two cards runs on the source
    card's current stream, ordered after the launch that wrote the
    source, and the receiving card's current stream waits for it
    (``Tensor.copy_`` between CUDA devices).  ``exchange_rows.copies``
    counts the copies: 2(R-1)*C per block clamped, 2R*C on rings of R > 1
    rows.  With ``ranks`` (a mesh across processes) the halos between two
    processes are sends and receives instead, and ``exchange_rows.sends``
    counts this process's sends.
    """
    n = len(chunks) // cols
    hl = _first(chunks).shape[0]
    if not 1 <= fr <= hl:
        raise ValueError(
            f"halo depth {fr} must be in [1, shard height {hl}]; lower "
            f"block_steps or use fewer shards"
        )
    if periodic and n == 1:
        return ([None if c is None else c[hl - fr:] for c in chunks],
                [None if c is None else c[:fr] for c in chunks])
    tops, bots = buffers if buffers is not None else halo_buffers(chunks, fr)
    moves = _Transfers(exchange_rows, ranks)
    for s in range(len(chunks)):
        i, j = divmod(s, cols)
        if i > 0 or periodic:
            t = (i - 1) % n * cols + j
            moves.move(tops[s], s, None if chunks[t] is None else [(None, chunks[t][hl - fr:])], t)
        if i < n - 1 or periodic:
            t = (i + 1) % n * cols + j
            moves.move(bots[s], s, None if chunks[t] is None else [(None, chunks[t][:fr])], t)
    moves.finish()
    return tops, bots


exchange_rows.copies = 0
exchange_rows.sends = 0


def exchange_cols(
    chunks: list[torch.Tensor],
    tops: list[torch.Tensor],
    bots: list[torch.Tensor],
    fc: int,
    *,
    cols: int,
    periodic: bool,
    buffers: tuple[list, list] | None = None,
    ranks: tuple[int, ...] | None = None,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The column halos of one block, after :func:`exchange_rows` gave
    ``tops`` and ``bots``: ``lefts[s]`` holds the last ``fc`` columns of
    the row-extended chunk left of shard s in its mesh row (that shard's
    top halo, chunk and bottom halo, ``fr + hl + fr`` rows) and
    ``rights[s]`` the first ``fc`` columns of the one right of it.  The
    corner cells thus come from the diagonal neighbours by way of the row
    exchange.

    Clamped, the first mesh column's lefts and the last one's rights are
    zeros; ``periodic`` closes the rings (a mesh of one column takes its
    own edges).  Each halo is three copies (the neighbour's top, chunk and
    bottom edge), into preallocated tensors on the receiving shard's
    device (``buffers``, from :func:`col_buffers`).  ``exchange_cols.copies``
    counts them: 6*R*(C-1) per block clamped, 6*R*C on rings.  Between two
    processes (``ranks``) a halo is one send of the three edges joined,
    counted by ``exchange_cols.sends``.
    """
    hl, wl = _first(chunks).shape
    fr = _first(tops).shape[0]
    if not 1 <= fc <= wl:
        raise ValueError(
            f"column halo {fc} must be in [1, shard width {wl}]; lower "
            f"block_steps or use fewer column shards"
        )
    lefts, rights = buffers if buffers is not None else col_buffers(chunks, fr, fc)
    moves = _Transfers(exchange_cols, ranks)
    pieces = ((slice(0, fr), tops), (slice(fr, fr + hl), chunks), (slice(fr + hl, None), bots))

    def edge(t: int, cut: slice) -> list | None:
        """Shard t's row-extended edge columns: its top halo's, its chunk's
        and its bottom halo's."""
        return None if chunks[t] is None else [(rows, src[t][:, cut]) for rows, src in pieces]

    for s in range(len(chunks)):
        i, j = divmod(s, cols)
        if j > 0 or periodic:
            t = i * cols + (j - 1) % cols
            moves.move(lefts[s], s, edge(t, slice(wl - fc, wl)), t)
        if j < cols - 1 or periodic:
            t = i * cols + (j + 1) % cols
            moves.move(rights[s], s, edge(t, slice(0, fc)), t)
    moves.finish()
    return lefts, rights


exchange_cols.copies = 0
exchange_cols.sends = 0


def _copy(dst: torch.Tensor, src: torch.Tensor, counter) -> None:
    with on_device(dst.device):
        dst.copy_(src, non_blocking=True)
    counter.copies += 1


def make_shard_block(
    rule: Rule,
    logical_shape: tuple[int, int],
    block_steps: int,
    *,
    packed: bool,
    torus: bool = False,
    split_cols: bool = False,
    stencil: str = "roll",
):
    """``block(top, chunk, bot, row0, left=None, right=None, col0=0)``:
    ``block_steps`` steps of one shard in plain ops.  The chunk and its
    ``r * block_steps``-row halos are stacked, the column halos (a mesh
    with ``split_cols``: ``left``/``right`` of :func:`col_halo_width`
    columns) joined beside them, the result stepped ``block_steps`` times
    and the chunk's cells kept.

    Clamped, each step is the masked step with the board coordinate of the
    extended chunk's cell (0, 0) (``row0``, and ``col0``: cells, or words
    when packed), packed (``bitlife.make_masked_packed_step``: Moore or
    diamond by the rule) or int8 (``stencil.make_masked_step``).  On the
    torus the halos are real cells, so nothing is masked: on a 1-D mesh
    packed life-like rules take ``make_packed_torus_step(wrap_rows=False)``
    (columns wrap at the logical width, padding bits re-masked), the rest
    ``make_wrap_cols_step`` on the unpadded int8 board; with column halos
    (the 2-D torus) the clamped twin of the rule runs unmasked, the zeros
    past the extended chunk's edges spoiling only the fringe the block
    drops.  The unpacked steps count by ``stencil`` (``roll`` or
    ``matmul``: operators sized to the extended chunk, built at its first
    step); a continuous rule's twin is the clamped float Lenia step.
    """
    lh, lw = logical_shape
    fr = halo_depth(rule, block_steps)
    fc = col_halo_width(rule, block_steps, packed) if split_cols else 0
    if torus and split_cols:
        twin = get_clamped_twin(rule)
        step = bitlife.make_packed_step(twin) if packed else make_step(twin, stencil)
        masked = lambda ext, row0, col0: step(ext)  # noqa: E731
    elif torus:
        step = (
            bitlife.make_packed_torus_step(rule, lw, wrap_rows=False)
            if packed
            else make_wrap_cols_step(rule)
        )
        masked = lambda ext, row0, col0: step(ext)  # noqa: E731
    elif packed:
        masked = bitlife.make_masked_packed_step(rule, (lh, lw))
    else:
        masked = make_masked_step(rule, (lh, lw), stencil)

    def block(top, chunk, bot, row0: int, left=None, right=None, col0: int = 0) -> torch.Tensor:
        if top.shape[0] != fr or bot.shape[0] != fr:
            raise ValueError(
                f"halos of {top.shape[0]} and {bot.shape[0]} rows, want "
                f"{fr} for {block_steps} steps of radius {rule.radius}"
            )
        hl, wl = chunk.shape
        ext = torch.cat([top, chunk, bot])
        if fc:
            if left is None or right is None:
                raise ValueError("a shard of a mesh of columns needs its left and right halos")
            want = (hl + 2 * fr, fc)
            if tuple(left.shape) != want or tuple(right.shape) != want:
                raise ValueError(
                    f"column halos of {tuple(left.shape)} and {tuple(right.shape)}, want {want}"
                )
            ext = torch.cat([left, ext, right], dim=1)
        elif left is not None or right is not None:
            raise ValueError("column halos given to a block without split_cols")
        for _ in range(block_steps):
            ext = masked(ext, row0, col0)
        return ext[fr: fr + hl, fc: fc + wl].contiguous()

    return block


def run_blocks(
    chunks: list[torch.Tensor],
    num_blocks: int,
    fr: int,
    block: Block,
    *,
    periodic: bool,
    buffers: tuple[list, list] | None = None,
    cols: int = 1,
    fc: int = 0,
    col_halos: tuple[list, list] | None = None,
    ranks: tuple[int, ...] | None = None,
) -> list[torch.Tensor]:
    """The epoch loop: ``num_blocks`` times, one exchange of ``fr``-row
    halos (and, with ``fc``, of ``fc``-column halos) and then
    ``block(s, chunk, halos, row0, col0)`` on every shard s = (i, j) of a
    mesh of ``cols`` columns that this process holds, which returns its
    new chunk.  Its ``row0`` is ``i * hl - fr`` and its ``col0``
    ``j * wl - fc``: the board coordinate of its extended chunk's cell
    (0, 0).  ``ranks`` names each shard's process on a mesh across
    processes (None stands for another process's chunk)."""
    hl, wl = _first(chunks).shape
    for _ in range(num_blocks):
        tops, bots = exchange_rows(
            chunks, fr, periodic=periodic, buffers=buffers, cols=cols, ranks=ranks
        )
        if fc:
            lefts, rights = exchange_cols(
                chunks, tops, bots, fc, cols=cols, periodic=periodic, buffers=col_halos,
                ranks=ranks,
            )
        else:
            lefts = rights = [None] * len(chunks)
        chunks = [
            None if chunk is None else
            block(s, chunk, Halos(tops[s], bots[s], lefts[s], rights[s]),
                  s // cols * hl - fr, s % cols * wl - fc)
            for s, chunk in enumerate(chunks)
        ]
    return chunks


def _make_run(rule, mesh: Mesh, logical_shape, block_steps: int, packed: bool, torus: bool,
              split_cols: bool, stencil: str = "roll"):
    block = make_shard_block(
        rule, logical_shape, block_steps, packed=packed, torus=torus, split_cols=split_cols,
        stencil=stencil,
    )
    fr = halo_depth(rule, block_steps)
    fc = col_halo_width(rule, block_steps, packed) if split_cols else 0
    cols = mesh.n_cols
    buffers: dict = {}

    def run(chunks: list[torch.Tensor], num_blocks: int) -> list[torch.Tensor]:
        if len(chunks) != mesh.size:
            raise ValueError(f"{len(chunks)} chunks for a mesh of {mesh.size}")
        if torus:
            hl, wl = _first(chunks).shape
            lh, lw = logical_shape
            exact = (lh, bitlife.packed_width(lw) if packed else lw)
            if mesh.n_rows * hl != exact[0] or (split_cols and cols * wl != exact[1]):
                raise ValueError(
                    f"torus shards of {hl}x{wl} on a {mesh.n_rows}x{cols} mesh do "
                    f"not tile the board's {exact[0]}x{exact[1]} exactly: padding "
                    f"would sit inside the glued seam"
                )
        if "halos" not in buffers:
            buffers["halos"] = halo_buffers(chunks, fr)
            buffers["cols"] = col_buffers(chunks, fr, fc) if fc else None
        return run_blocks(
            chunks, num_blocks, fr,
            lambda s, chunk, h, row0, col0: block(h.top, chunk, h.bot, row0, h.left, h.right, col0),
            periodic=torus, buffers=buffers["halos"], cols=cols, fc=fc,
            col_halos=buffers["cols"], ranks=mesh.ranks,
        )

    return run


def make_sharded_run_2d(
    rule: Rule,
    mesh: Mesh,
    logical_shape: tuple[int, int],
    *,
    block_steps: int,
    packed: bool,
    torus: bool = False,
    stencil: str = "roll",
) -> Callable[[list[torch.Tensor], int], list[torch.Tensor]]:
    """``run(chunks, num_blocks)``: ``num_blocks * block_steps`` steps of a
    board split in blocks over a mesh, one chunk per mesh device in
    row-major order, in plain ops; halos exchanged along both mesh axes
    once per block (the column exchange drops out on a mesh of one clamped
    column, and this is the 1-D stripe run).  ``torus=True`` (the checked
    entry point is :func:`make_sharded_run_torus_2d`) closes both rings
    and runs the clamped twin unmasked; the chunks must then tile the
    board exactly along both axes.  ``stencil`` is the unpacked steps'
    counting path."""
    split_cols = mesh.n_cols > 1 or torus
    return _make_run(rule, mesh, logical_shape, block_steps, packed, torus, split_cols, stencil)


def make_sharded_run_torus(
    rule: Rule,
    mesh: Mesh,
    logical_shape: tuple[int, int],
    *,
    block_steps: int,
    packed: bool,
) -> Callable[[list[torch.Tensor], int], list[torch.Tensor]]:
    """The torus on a 1-D row mesh: the ring is closed and each shard wraps
    its columns in place.  The chunks must hold the board's rows exactly
    (no padding rows inside the seam)."""
    return _make_run(rule, mesh, logical_shape, block_steps, packed, torus=True, split_cols=False)


def make_sharded_run_torus_2d(
    rule: Rule,
    mesh: Mesh,
    logical_shape: tuple[int, int],
    *,
    block_steps: int,
    packed: bool,
    stencil: str = "roll",
) -> Callable[[list[torch.Tensor], int], list[torch.Tensor]]:
    """The torus on a 2-D mesh: closed rings along both axes, so every
    seam, the board's edges included, is an interior seam and the local
    step needs no wrap.  Packed boards need a word-aligned width (a
    partial last word would sit inside the glued seam); the chunks must
    tile the board exactly.  A mesh of one column is its own ring (the
    scaffold of continuous and matmul rules on a row mesh)."""
    lh, lw = logical_shape
    if packed and lw % bitlife.WORD:
        raise ValueError(
            f"2-D torus needs a word-aligned width (got {lw}); a partial "
            f"last word would sit inside the glued seam"
        )
    return make_sharded_run_2d(
        rule, mesh, logical_shape, block_steps=block_steps, packed=packed, torus=True,
        stencil=stencil,
    )
