"""Kernel K1: k bit-sliced steps per pass, hand-written CUDA, in two modes.

Replaces the TPU kernel ``make_pallas_packed_multi_step`` and its body
``_packed_tile_advance`` (``tpu_life/backends/pallas_backend.py``): the
Moore mode for clamped life-like rules, and the diamond mode for clamped
2-state von Neumann rules of radius 1 or 2 (``bitlife.supports_diamond``).
The source is ``tpu_life_torch/csrc/packed_stripe.cu``; it is compiled by
``nvcc`` for ``sm_90a`` at first use (``kernels._build``) and called
through ``ctypes``.

The function both versions compute: ``steps`` masked steps of a packed
board — int32 words in the ``bitlife.pack_np`` layout, shape
``(lh, ceil(lw / 32))``, no frame — each step equal to
``bitlife.make_masked_packed_step(rule, (lh, lw))``, which picks the Moore
or the diamond step by the rule.

What bounds the kernel on an H100 is integer issue (the benchmark counts
15 logic instructions a word and step for Conway,
:func:`logic_ops_per_word_step`), so its design spends few instructions
beyond those and keeps every row of a substep in registers: a warp owns a
strip of 32 word columns, and a block keeps a tile of a strip's rows,
computing all of them each substep (the CUDA source's note).  The Moore
mode counts in the other order: each row's horizontal 3-sum once, traded
between warps as two planes, then two vertical carry-save adds and Conway's
rule on the carry-save planes, 12 integer-pipe instructions and 2 shuffles
a word and step; only the blocks that touch the board's edge mask rows and
columns (:func:`moore_blocks`).  What the wrapper decides for a launch:

- the tile: its output rows and the rows a warp keeps, and so its warps and
  halo, sized to the board.  The Moore mode's (:func:`moore_tile_shape`)
  take 4, 8 or 16 rows a warp, a kernel instance each, by depth, as
  measured at 16384^2 (8 warps of 16 rows at depth 8); the diamond's
  (:func:`tile_shape`, which K3, K5 and K1's batch mode share) 4 or 8;
- the kernel instance: for the Moore mode, Conway's rule compiled in where
  the rule's minimized SOP is Conway's (:func:`compiled_rule`), else the
  rule as data (:func:`sop_table`).

- :func:`packed_multi_step` launches the kernel for a CUDA tensor:
  ``steps // block_steps`` launches of ``block_steps`` substeps each, then
  one launch for the remainder.  A diamond of radius r reaches r cells a
  substep, so its depth is clamped to ``32 // r``.  For a CPU tensor it
  runs the plain version.  Any other device raises; nothing falls back.
- :func:`packed_multi_step_plain` is the plain PyTorch version, on any
  device: the CPU tests use it, and ``chip_smoke.py`` holds the kernel to
  it on the card.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from contextlib import nullcontext
from pathlib import Path

import torch

from tpu_life_torch.kernels import _build
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.obs import profiler_span
from tpu_life_torch.ops import bitlife
from tpu_life_torch.ops.boolmin import membership_rule_sop, rule_sop

SOURCE = _build.CSRC / "packed_stripe.cu"
MAX_BLOCK_STEPS = 32  # the one-word horizontal halo covers 32 cells of reach
STRIP_WORDS = 30  # output words of a warp's strip: kInterior in the CUDA source
SCHEDULERS_PER_SM = 4  # warp schedulers of a Hopper SM
SMALL_WARP_ROWS, LARGE_WARP_ROWS = 4, 8  # rows a warp keeps in a tile: the kernel's R
TILE_WARPS = 32  # warps of a tile's block, at most: kTileWarps in the CUDA source
# the Moore mode's rows a warp (an instance each), and the tall instance's
# warps a block, at most (kMooreTallRows, kMooreTallWarps in the CUDA source)
MOORE_WARP_ROWS = (4, 8, 16)
MOORE_TALL_ROWS, MOORE_TALL_WARPS = 16, 8
# the Moore mode's blocks on a board that fills the card: (deepest launch,
# rows a warp, warps), and the warps an SM its grid must give (moore_tile_shape)
MOORE_BLOCKS = ((2, 8, 8), (5, 16, 4), (12, 16, 8), (MAX_BLOCK_STEPS, 8, 32))
MOORE_WARPS_PER_SM = 16
CONWAY_SOP = ((7, 3), (23, 20))  # rule_sop of B3/S23, compiled into the Moore kernels
_MAX_TERMS = 32
_LITERALS = 5
_ALWAYS_EVALUATED = 2  # SOP terms the kernel evaluates without a test
_ONES = 0xFFFFFFFF


class _Sop(ctypes.Structure):
    """Mirror of ``struct Sop`` in the CUDA source."""

    _fields_ = [
        ("n_terms", ctypes.c_int),
        ("flip", (ctypes.c_uint32 * _LITERALS) * _MAX_TERMS),
        ("loose", (ctypes.c_uint32 * _LITERALS) * _MAX_TERMS),
    ]


def _rule_sop(rule: Rule) -> tuple[tuple[tuple[int, int], ...], list[int]]:
    """The rule's minimized SOP and, for each of its input bits, the
    kernel literal (b0..b3 = 0..3, the cell = 4) that carries it.  A
    life-like rule reads the total's four planes and the cell at bit 4
    (``boolmin.rule_sop``); a diamond reads the raw count's ``nplanes``
    planes and the cell right after them, at bit ``nplanes``
    (``boolmin.membership_rule_sop``)."""
    if bitlife.supports_diamond(rule):
        nplanes, sop = membership_rule_sop(
            rule.birth, rule.survive, bitlife.diamond_count_max(rule)
        )
        return sop, [*range(nplanes), _LITERALS - 1]
    return rule_sop(rule.birth, rule.survive), list(range(_LITERALS))


def sop_table(rule: Rule) -> _Sop:
    """The rule's minimized SOP as kernel data:
    term t = AND_i ((lit_i ^ flip[t][i]) | loose[t][i]).  A literal the
    SOP has no bit for (a count plane a small diamond never reaches) is
    loose in every term.  The kernel always evaluates terms 0 and 1, so a
    one-term SOP repeats its term there, and an empty one holds
    b1 b2 b3 twice, which no count reaches (a total is at most 9, a
    diamond's count 13)."""
    sop, literal_of_bit = _rule_sop(rule)
    if len(sop) > _MAX_TERMS:
        raise ValueError(f"rule {rule.name!r} needs {len(sop)} SOP terms (> {_MAX_TERMS})")
    table = _Sop(n_terms=len(sop))
    terms = [(mask, value, literal_of_bit) for mask, value in sop]
    terms = terms or [(0b1110, 0b1110, range(_LITERALS))]
    for t in range(max(len(sop), _ALWAYS_EVALUATED)):
        mask, value, literals = terms[min(t, len(terms) - 1)]
        for i in range(_LITERALS):
            table.flip[t][i] = table.loose[t][i] = _ONES
        for bit, i in enumerate(literals):
            table.flip[t][i] = 0 if value >> bit & 1 else _ONES
            table.loose[t][i] = 0 if mask >> bit & 1 else _ONES
    return table


def _diamond_logic_ops(rule: Rule) -> int:
    """:func:`logic_ops_per_word_step` for a diamond.  Radius 1: two
    funnel shifts (L1, R1); two carry-save adds over up, down, L1, R1 and
    the centre (sum and majority, 2 each); the planes b1 and b2, one each.
    Radius 2: four funnel shifts (L1, R1, L2, R2 of the row, formed once and
    used first in the box of the row above); the row's 3-wide box, one
    carry-save add (2); four carry-save adds of the nine weight-1 planes
    (8); two of the six weight-2 planes (4), then b1 and the carry beside
    it (2); one of the weight-4 planes (b2 and b3, one each).  Then the
    rule's SOP as one read-once formula of L literals, L // 2 instructions.
    A top plane the SOP does not read is not counted."""
    sop, literal_of_bit = _rule_sop(rule)
    read = functools.reduce(operator.or_, (mask for mask, _ in sop), 0)
    planes_read = {i for bit, i in enumerate(literal_of_bit) if read >> bit & 1}
    literals = sum(bin(mask).count("1") for mask, _ in sop)
    if rule.radius == 1:
        return 2 + 4 + (1 in planes_read) + (2 in planes_read) + literals // 2
    return 4 + 2 + 8 + 4 + 2 + (2 in planes_read) + (3 in planes_read) + literals // 2


def logic_ops_per_word_step(rule: Rule) -> int:
    """The 32-bit logic instructions one word needs per step, where one
    Hopper ``LOP3`` computes any function of three inputs.  For a diamond
    see :func:`_diamond_logic_ops`.  For a life-like rule: the vertical
    carry-save add (sum and majority, 2); the funnel shifts that build the
    left and right neighbour planes (2 for ones, 2 for twos); the
    horizontal carry-save adds (b0 = sum of the ones, and the carries c1,
    s1, c2); the planes b1 = c1^s1, b2 = c2^(c1&s1), b3 = c2&c1&s1, one each;
    and the rule's SOP as one read-once formula of L literals, L // 2
    instructions.  A plane the SOP does not read is not counted.  The board
    mask, needed only on a partial last word, is counted by the caller.
    This is the count of the shared tiles and of the benchmark's bound; the
    Moore mode's own body needs 12 for Conway (the CUDA source's note)."""
    if bitlife.supports_diamond(rule):
        return _diamond_logic_ops(rule)
    return moore_logic_ops(rule.birth, rule.survive)


def moore_logic_ops(birth: frozenset, survive: frozenset) -> int:
    """:func:`logic_ops_per_word_step` of the life-like Moore rule whose
    birth and survive sets count the 8 neighbours."""
    sop = rule_sop(birth, survive)
    read = functools.reduce(operator.or_, (mask for mask, _ in sop), 0)
    high = bool(read & 0b1110)  # b1..b3 need the twos plane and the carries
    literals = sum(bin(mask).count("1") for mask, _ in sop)
    return (
        2
        + 2 + 2 * high
        + (read & 1) + 3 * high
        + bin(read & 0b1110).count("1")
        + literals // 2
    )


def clamp_block_steps(rule: Rule, block_steps: int) -> int:
    """The substeps of one launch: a rule of radius r reaches r cells a
    substep, and the strip's one word beside its output words covers 32 of
    them."""
    return min(block_steps, MAX_BLOCK_STEPS // rule.radius)


def compiled_rule(rule: Rule) -> bool:
    """Whether the Moore kernels run ``rule`` with Conway's rule compiled
    in: a life-like rule (clamped or torus) whose minimized SOP is
    Conway's, whatever its name.  Every other rule runs as data."""
    if bitlife.supports_diamond(rule) or not (bitlife.supports(rule) or bitlife.supports_torus(rule)):
        return False
    return rule_sop(rule.birth, rule.survive) == CONWAY_SOP


def fills_card(block_steps: int, height: int, nwords: int, n_sm: int, radius: int = 1) -> bool:
    """Whether a board's runs of two halos (``2 * radius * block_steps``
    rows) give more warps than the card has schedulers: below that, a
    launch's time is its critical path (:func:`tile_shape`)."""
    strips = -(-nwords // STRIP_WORDS)
    return strips * -(-height // (2 * radius * block_steps)) > SCHEDULERS_PER_SM * n_sm


def tile_shape(
    block_steps: int, height: int, nwords: int, n_sm: int, radius: int = 1
) -> tuple[int, int]:
    """``(tile_rows, warp_rows)`` of a launch: the output rows of one tile
    (the rows a block computes for a strip, less its halo of ``radius *
    block_steps`` rows at each end), and the rows each of its warps keeps.

    A tile of ``w`` warps keeps ``w * warp_rows`` rows (at most
    :data:`TILE_WARPS` warps) and its warps share their SM's
    :data:`SCHEDULERS_PER_SM` warp schedulers.  Taller tiles recompute less
    halo; shorter ones, and fewer rows a warp, put less on each scheduler.
    So:

    - a board whose runs of two halos (``2 * radius * block_steps`` rows)
      give no more warps than the card has schedulers cannot fill the card
      anyway: its time is the critical path, and it takes
      :data:`SMALL_WARP_ROWS` rows a warp and the tile whose blocks put the
      fewest warps on a scheduler, ties to the fewer warps;
    - a larger board takes :data:`LARGE_WARP_ROWS` rows a warp and the
      fewest warps (4, 8, 16 or 32) whose halo is at most a sixth of their
      rows, so that several blocks share an SM and hide each other's
      loads."""
    halo = 2 * radius * block_steps
    if not fills_card(block_steps, height, nwords, n_sm, radius):
        return _critical_path_tile(halo, height, -(-nwords // STRIP_WORDS), n_sm)
    r = LARGE_WARP_ROWS
    warps = next((w for w in (4, 8, 16) if 6 * halo <= w * r), TILE_WARPS)
    return min(warps * r - halo, height), r


def _critical_path_tile(halo: int, height: int, strips: int, n_sm: int) -> tuple[int, int]:
    """The tile of a board too small to fill the card: four rows a warp and
    the tile whose blocks put the fewest warps on a warp scheduler, ties to
    the fewer warps."""
    r, best = SMALL_WARP_ROWS, None
    for warps in range(halo // r + 1, TILE_WARPS + 1):
        rows = min(warps * r - halo, height)
        per_scheduler = -(-strips * -(-height // rows) // n_sm) * -(-warps // SCHEDULERS_PER_SM)
        if best is None or per_scheduler < best[0]:
            best = (per_scheduler, rows)
    return best[1], r


def moore_strips(nwords: int) -> int:
    """The strips of the Moore mode's tiles (``moore_strips`` in the CUDA
    source): strip ``s`` holds word columns ``30 s .. 30 s + 31``, and its
    output words are lanes 1..30, lane 0 of the first strip and a lane 31
    that holds the row's last word."""
    return 1 if nwords <= 2 else -(-(nwords - 2) // STRIP_WORDS)


def moore_max_warps(warp_rows: int) -> int:
    """The warps a block of the Moore mode's instance of ``warp_rows`` rows
    a warp may have."""
    return MOORE_TALL_WARPS if warp_rows == MOORE_TALL_ROWS else TILE_WARPS


def moore_tile_shape(block_steps: int, height: int, nwords: int, n_sm: int) -> tuple[int, int]:
    """``(tile_rows, warp_rows)`` of a Moore launch: the output rows of one
    tile (the rows a block computes for a strip, less its halo of
    ``block_steps`` rows at each end), and the rows each of its warps keeps.

    The block by depth (:data:`MOORE_BLOCKS`, the fastest at 16384^2 on an
    H100 at every depth, PERF.md): 8 warps of 8 rows at depths 1 and 2,
    where the loads and stores weigh most; 4 warps of 16 rows up to depth 5;
    8 warps of 16 up to depth 12; then 32 warps of 8, whose halo is the
    smallest share of their rows.  A board whose grid of such blocks gives
    fewer than :data:`MOORE_WARPS_PER_SM` warps an SM cannot fill the card:
    its time is the critical path, and it takes the tile of
    :func:`tile_shape`'s small boards."""
    warp_rows, warps = next(b for depth, *b in MOORE_BLOCKS if block_steps <= depth)
    rows = min(warps * warp_rows - 2 * block_steps, height)
    strips = moore_strips(nwords)
    if strips * -(-height // rows) * warps >= MOORE_WARPS_PER_SM * n_sm:
        return rows, warp_rows
    return _critical_path_tile(2 * block_steps, height, strips, n_sm)


def moore_blocks(block_steps: int, height: int, nwords: int, tile_rows: int,
                 warp_rows: int) -> tuple[int, int]:
    """``(blocks, unmasked)`` of a Moore launch: its grid, and the blocks
    that touch no edge of the board and so run the body with no mask: tile
    ``t``'s rows and halo, from ``t * tile_rows - block_steps`` on, all on
    the board, in a strip ``s >= 1`` whose lanes stop short of the row's
    last word (``30 s + 32 < nwords``)."""
    strips = moore_strips(nwords)
    tiles = -(-height // tile_rows)
    rows = -(-(tile_rows + 2 * block_steps) // warp_rows) * warp_rows
    inner_strips = max(0, min(strips - 1, (nwords - 33) // STRIP_WORDS))
    last = height - rows + block_steps  # the highest tile start whose rows end on the board
    inner_tiles = 0
    if last >= 0:
        inner_tiles = max(0, min(tiles - 1, last // tile_rows) - -(-block_steps // tile_rows) + 1)
    return strips * tiles, inner_strips * inner_tiles


def build() -> Path:
    """Compile the kernel library (``_build.build``) and return its path;
    ``build.log`` beside it keeps nvcc's ``-Xptxas -v`` report."""
    return _build.build(SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.library(SOURCE)
    ints = [ctypes.c_int] * 6  # height, nwords, rem_bits, k, tile_rows, warp_rows
    for fn, mode in ((lib.packed_stripe_multi_step, [ctypes.c_int]),  # compiled
                     (lib.packed_diamond_multi_step, [ctypes.c_int] * 2)):  # radius, center
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, *ints, *mode, ctypes.POINTER(_Sop),
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    # kernel K3 (kernels/sharded_stripe.py): top, chunk, bot, dst; rows, fr,
    # row0, height, width, k, tile_rows, warp_rows, mode, radius, center,
    # compiled; sop, stream
    lib.sharded_stripe_block.argtypes = [
        *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 12, ctypes.POINTER(_Sop), ctypes.c_void_p,
    ]
    lib.sharded_stripe_block.restype = ctypes.c_int
    # kernel K5 (kernels/conway_block.py): src, dst; n, k, tile_rows,
    # warp_rows; stream
    lib.conway_block_int8.argtypes = [*[ctypes.c_void_p] * 2, *[ctypes.c_int] * 4, ctypes.c_void_p]
    lib.conway_block_int8.restype = ctypes.c_int
    # K1's batch mode (kernels/packed_batch.py): src, dst, steps; slots,
    # offset, height, nwords, rem_bits, k, tile_rows, warp_rows, seg,
    # diamond, radius, center, compiled; sop, stream
    lib.packed_batch_multi_step.argtypes = [
        *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 13, ctypes.POINTER(_Sop), ctypes.c_void_p,
    ]
    lib.packed_batch_multi_step.restype = ctypes.c_int
    return lib


@functools.cache
def cached_sop_table(rule: Rule) -> _Sop:
    """:func:`sop_table`, built once per rule."""
    return sop_table(rule)


def launch_tile_shape(rule: Rule, k: int, rows: int, nwords: int) -> tuple[int, int]:
    """:func:`tile_shape` of one launch of ``k`` substeps over ``rows`` x
    ``nwords`` words on the current card."""
    return tile_shape(k, rows, nwords, sm_count(torch.cuda.current_device()), rule.radius)


@functools.cache
def _moore_launch(k: int, rows: int, nwords: int, device: int) -> tuple[int, int, int, int]:
    """``(tile_rows, warp_rows, blocks, unmasked)`` of one Moore launch on
    card ``device``, reckoned once per shape and depth."""
    tiles = moore_tile_shape(k, rows, nwords, sm_count(device))
    return (*tiles, *moore_blocks(k, rows, nwords, *tiles))


@functools.cache
def sm_count(device: int) -> int:
    """The SMs of card ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(x: torch.Tensor, logical_shape: tuple[int, int], name: str) -> None:
    lh, lw = logical_shape
    want = (lh, bitlife.packed_width(lw))
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 words, got {x.dtype}")
    if tuple(x.shape) != want:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, want {want} for a {lh}x{lw} board")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def packed_multi_step_plain(
    x: torch.Tensor, rule: Rule, logical_shape: tuple[int, int], steps: int
) -> torch.Tensor:
    """The plain PyTorch version: ``bitlife``'s masked packed step (Moore
    or diamond, by the rule) applied ``steps`` times, on ``x``'s device.
    Returns a new tensor."""
    return bitlife.multi_step_packed(
        x, rule=rule, steps=steps, logical_shape=tuple(logical_shape)
    )


def packed_multi_step(
    x: torch.Tensor,
    rule: Rule,
    logical_shape: tuple[int, int],
    steps: int,
    *,
    block_steps: int,
    scratch: torch.Tensor | None = None,
) -> torch.Tensor:
    """``steps`` masked steps of the packed board ``x``, for a clamped
    life-like rule or a clamped 2-state von Neumann rule of radius <= 2.

    On a CUDA tensor each launch reads one buffer and writes the other,
    ping-ponging between ``x`` and ``scratch`` (allocated when None), and
    the function returns whichever holds the result: afterwards the
    contents of ``x`` and ``scratch`` are unspecified.  On a CPU tensor it
    returns the plain version's new tensor.  On the card, a
    ``torch.profiler`` trace holds one ``k1.prepare`` span a call (entry to
    just before the first launch) and one ``k1.issue`` (the launches).
    """
    on_card = x.device.type == "cuda"
    with profiler_span("k1.prepare") if on_card else nullcontext():
        diamond = bitlife.supports_diamond(rule)
        if not (diamond or bitlife.supports(rule)):
            raise ValueError(
                f"the packed stripe kernel runs clamped life-like rules and clamped "
                f"2-state von Neumann rules of radius <= 2 only, got {rule}"
            )
        if not 1 <= block_steps <= MAX_BLOCK_STEPS:
            raise ValueError(f"block_steps must be in [1, {MAX_BLOCK_STEPS}], got {block_steps}")
        if steps < 0:
            raise ValueError(f"steps must be >= 0, got {steps}")
        _check(x, logical_shape, "x")
        if x.device.type == "cpu":
            return packed_multi_step_plain(x, rule, logical_shape, steps)
        if not on_card:
            raise ValueError(f"packed_multi_step runs on cuda or cpu tensors, got {x.device}")
        if scratch is None:
            scratch = torch.empty_like(x)
        _check(scratch, logical_shape, "scratch")
        if scratch.device != x.device or scratch.data_ptr() == x.data_ptr():
            raise ValueError("scratch must be a second buffer on x's device")
        lh, lw = logical_shape
        block_steps = clamp_block_steps(rule, block_steps)
        blocks, rem = divmod(steps, block_steps)
        ks = [block_steps] * blocks + ([rem] if rem else [])
        lib = _library()
        compiled = compiled_rule(rule)
        if diamond:
            fn, mode = lib.packed_diamond_multi_step, (rule.radius, int(rule.include_center))
        else:
            fn, mode = lib.packed_stripe_multi_step, (int(compiled),)
        sop = cached_sop_table(rule)
        nwords = x.shape[1]
        src, dst = x, scratch
    with profiler_span("k1.issue"), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for k in ks:
            if diamond:
                tiles, blocks, unmasked = launch_tile_shape(rule, k, lh, nwords), 0, 0
            else:
                *tiles, blocks, unmasked = _moore_launch(k, lh, nwords, x.device.index)
            err = fn(
                src.data_ptr(), dst.data_ptr(), lh, nwords, lw % bitlife.WORD, k,
                *tiles, *mode, ctypes.byref(sop), stream,
            )
            if err != 0:
                raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
            packed_multi_step.launches += 1
            packed_multi_step.diamond_launches += diamond
            packed_multi_step.blocks += blocks
            packed_multi_step.unmasked_blocks += unmasked
            src, dst = dst, src
    return src


# launches of either mode, and those of them that ran the diamond mode; the
# Moore mode's blocks, and those of them that ran with no mask (moore_blocks)
packed_multi_step.launches = 0
packed_multi_step.diamond_launches = 0
packed_multi_step.blocks = 0
packed_multi_step.unmasked_blocks = 0
