"""Bitplane-packed checkerboard Metropolis: 32 spins per uint32 word (from
``tpu_life/mc/packed.py``).

Layout (shared with ``ops.bitlife``): spin (r, c) is bit ``c % 32``
(LSB-first) of word ``c // 32`` in a uint32[H, ceil(W/32)] bitboard;
bit 1 = state 1 = spin up.  Because 32 is even, the checkerboard falls
out of the packing: the active-parity cells of row ``r`` are the bits at
positions ``(r + parity) & 1 (mod 2)`` of EVERY word — a constant
0x55555555 / 0xAAAAAAAA mask per row.

One half-sweep, all in the packed domain:

- the 4 torus neighbor planes are word shifts (rows roll; columns shift
  in-lane with an adjacent-word carry, wrapping at the logical width);
- carry-save adders reduce them to the 3 bitplanes of the alive-neighbor
  count ``n4`` in 0..4.  The table index ``i = (s·nsum + 4) >> 1`` of the
  roll path is ``n4`` for an up spin and ``4 - n4`` for a down spin, so
  the 5-way lookup becomes two bitplanes: ``needs3`` (i == 3) and
  ``needs4`` (i == 4); everything else force-accepts (ΔE <= 0);
- Threefry draws are evaluated only for the active-parity cells at the
  roll path's counters ``(r*w + c + origin, step*NSUB + substream)`` and
  compared against the table's entries 3 and 4;
- ``flip = (force | needs3&cmp3 | needs4&cmp4) & parity & column-mask``
  and the accepted proposals apply as one XOR.

Bit-identical to the int8 roll path of ``mc.ising``.  Boards past 2^32
cells address the PRNG through ``prng.derive_wide_keys``; ``origin``
places a board anywhere in the 64-bit index space.

:func:`make_sweep` has a numpy form (a copy of the JAX package's, the
oracle) and a torch form on int32 views of the words, whose half-sweep
:func:`half_sweep_torch` is the plain version of kernel K6
(``kernels.mc_threefry.packed_metropolis_half``) and whose batched
half-sweep :func:`half_sweep_batch_torch` is the plain version of K6's
batch mode (``packed_metropolis_half_batch``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_life_torch.mc import prng, validate_board_shape
from tpu_life_torch.models.rules import IsingRule, Rule

WORD = 32
#: spins per uint32 lane — the observability stamp packed runners carry
LANES = WORD
_U1 = np.uint32(1)
_LITTLE = sys.byteorder == "little"


def supports(rule: Rule) -> bool:
    """The packed Metropolis path covers exactly the ising family:
    2-state spins, radius-1 von Neumann coupling, torus topology."""
    return isinstance(rule, IsingRule)


def packed_width(width: int) -> int:
    return -(-width // WORD)


# -- pack / unpack (host-side; the twin of bitlife.pack_np) -----------------

def pack_board(board: np.ndarray) -> np.ndarray:
    """int8[H, W] {0,1} spins -> uint32[H, ceil(W/32)] (LSB-first), the
    byte-for-byte layout of ``ops.bitlife.pack_np``."""
    h, w = board.shape
    alive = board == 1
    wp = packed_width(w) * WORD
    if wp != w:
        alive = np.pad(alive, ((0, 0), (0, wp - w)))
    if _LITTLE:
        by = np.packbits(alive, axis=1, bitorder="little")
        return np.ascontiguousarray(by).view(np.uint32)
    bits = alive.astype(np.uint32).reshape(h, wp // WORD, WORD)
    weights = (_U1 << np.arange(WORD, dtype=np.uint32)).astype(np.uint32)
    return (bits * weights).sum(axis=-1, dtype=np.uint32)


def unpack_board(packed: np.ndarray, width: int) -> np.ndarray:
    """uint32[H, Wp] bitboard -> int8[H, width] {0,1} spins."""
    packed = np.asarray(packed)
    h, wp = packed.shape
    if _LITTLE:
        by = np.ascontiguousarray(packed).view(np.uint8)
        bits = np.unpackbits(by, axis=1, bitorder="little")
        return bits[:, :width].astype(np.int8)
    shifts = np.arange(WORD, dtype=np.uint32)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & _U1
    return bits.reshape(h, wp * WORD)[:, :width].astype(np.int8)


def column_mask(width: int) -> np.ndarray:
    """uint32[ceil(width/32)] with exactly the valid-column bits set."""
    wp = packed_width(width)
    rem = width % WORD
    m = np.full(wp, 0xFFFFFFFF, np.uint32)
    if rem:
        m[-1] = np.uint32((1 << rem) - 1)
    return m


def live_count(packed: np.ndarray) -> int:
    """Exact count of up spins in a packed bitboard (host-side)."""
    by = np.ascontiguousarray(np.asarray(packed)).view(np.uint8)
    return int(np.unpackbits(by).sum())


# -- torus shifts (numpy) ------------------------------------------------------

def _make_torus_hshifts(xp, width: int):
    """(left, right) packed neighbor-plane shifts wrapping at the logical
    width, on numpy (the xp-generic form of the JAX package, kept so the
    copy reads as the original)."""
    wp = packed_width(width)
    rem = width % WORD
    top = np.uint32((rem or WORD) - 1)  # bit index of column width-1
    u1, u31 = np.uint32(1), np.uint32(WORD - 1)

    def hshift_left(x):
        """L[c] = x[(c-1) mod width]."""
        if wp == 1:
            wrap = (x >> top) & u1
            return (x << u1) | wrap
        carry = xp.roll(x, 1, axis=1)  # carry[j] = x[j-1]; [0] = x[wp-1]
        if rem:
            # bit rem-1 of the last word must land at bit 31 of the
            # virtual word left of word 0
            seam = x[:, -1:] << np.uint32(WORD - rem)
            carry = xp.concatenate([seam, carry[:, 1:]], axis=1)
        return (x << u1) | (carry >> u31)

    def hshift_right(x):
        """R[c] = x[(c+1) mod width]."""
        if wp == 1:
            wrap = (x & u1) << top
            return (x >> u1) | wrap
        carry = xp.roll(x, -1, axis=1)  # carry[j] = x[j+1]; [wp-1] = x[0]
        out = (x >> u1) | (carry << u31)
        if rem:
            # last word: column width-1 (bit rem-1) receives column 0
            last = (x[:, -1:] >> u1) | ((x[:, :1] & u1) << top)
            out = xp.concatenate([out[:, :-1], last], axis=1)
        return out

    return hshift_left, hshift_right


# -- the packed sweep (numpy) --------------------------------------------------

def _parity_draw_coords(h: int, w: int, parity: int, origin: int):
    """Draw coordinates of the active-parity cells, compacted row-wise.

    Row ``r``'s active cells sit at columns ``c = a_r + 2k`` with
    ``a_r = (r + parity) & 1``; their flat indices are precomputed here
    as ``(lo, hi)`` uint32 word pairs (``hi`` None when every index fits
    the narrow schedule).  The compact layout is padded to
    ``ceil(w/32) * 16`` entries per row so it reshapes exactly onto the
    lane-spread below; padding entries duplicate the row's last active
    index — their draws land on padding bit positions the column mask
    zeroes, so they are never consumed.
    """
    w2 = w // 2
    w2p = packed_width(w) * (WORD // 2)
    offs = (np.arange(h, dtype=np.int64) + parity) & 1
    k = np.minimum(np.arange(w2p, dtype=np.int64), w2 - 1)
    cols = offs[:, None] + 2 * k[None, :]
    idx = np.arange(h, dtype=np.int64)[:, None] * w + cols + int(origin)
    lo, hi = prng.split_cell_index(idx)
    if not hi.any():
        hi = None
    return lo, hi, offs.astype(np.uint32)


def _spread_to_lanes(xp, cmp_bits, h: int, wp: int, row_off):
    """bool[h, wp*16] compact active-parity bits -> uint32[h, wp] masks
    with each bit at its lane position ``row_off[r] + 2t`` of word j."""
    bits = cmp_bits.reshape(h, wp, WORD // 2).astype(xp.uint32)
    weights = (_U1 << (2 * np.arange(WORD // 2, dtype=np.uint32))).astype(
        np.uint32
    )
    words = (bits * weights).sum(axis=-1, dtype=xp.uint32)
    return xp.where(row_off[:, None] == 1, words << _U1, words)


def _make_sweep_np(rule: Rule, shape: tuple[int, int], origin: int):
    """The numpy form of :func:`make_sweep` (the JAX package's with
    ``xp = numpy``, whose draw coordinates are build-time tables)."""
    h, w = int(shape[0]), int(shape[1])
    wp = packed_width(w)
    hshift_left, hshift_right = _make_torus_hshifts(np, w)
    cmask = np.broadcast_to(column_mask(w)[None, :], (h, wp)).copy()
    aux = {}
    for parity, substream in ((0, prng.SUB_EVEN), (1, prng.SUB_ODD)):
        row_off = ((np.arange(h) + parity) & 1).astype(np.uint32)
        lo, hi, _ = _parity_draw_coords(h, w, parity, origin)
        pmask = np.where(
            row_off == 1, np.uint32(0xAAAAAAAA), np.uint32(0x55555555)
        )
        flip_mask = np.broadcast_to(pmask[:, None], (h, wp)) & cmask
        aux[parity] = (substream, lo, hi, row_off, flip_mask)

    def half(x, k0, k1, step, thr, parity):
        substream, lo, hi, row_off, flip_mask = aux[parity]
        up = np.roll(x, -1, axis=0)
        down = np.roll(x, 1, axis=0)
        left = hshift_left(x)
        right = hshift_right(x)
        # carry-save reduce the 4 neighbor planes to n4's bitplanes
        s1 = up ^ down ^ left
        c1 = (up & down) | ((up ^ down) & left)
        b0 = s1 ^ right  # weight 1
        c2 = s1 & right
        b1 = c1 ^ c2  # weight 2
        b2 = c1 & c2  # weight 4 (n4 == 4)
        # table index i = n4 for an up spin, 4 - n4 for a down spin:
        # i == 3  <=>  (up & n4==3) | (down & n4==1)
        # i == 4  <=>  (up & n4==4) | (down & n4==0);  i <= 2 force-accepts
        n3 = b0 & b1 & ~b2
        n1 = b0 & ~b1 & ~b2
        n0 = ~(b0 | b1 | b2)
        needs3 = (x & n3) | (~x & n1)
        needs4 = (x & b2) | (~x & n0)
        u = prng.cell_uniforms_at(lo, hi, k0, k1, step, substream)
        cmp3 = _spread_to_lanes(np, u < thr[3], h, wp, row_off)
        cmp4 = _spread_to_lanes(np, u < thr[4], h, wp, row_off)
        accept = ~(needs3 | needs4) | (needs3 & cmp3) | (needs4 & cmp4)
        return x ^ (accept & flip_mask)

    def sweep(x, k0, k1, step, thr):
        x = half(x, k0, k1, step, thr, 0)
        x = half(x, k0, k1, step, thr, 1)
        return x

    return sweep


# -- the packed half-sweep (torch): the plain version of kernel K6 -------------

def _half_sweep_words(x, parity, k0, k1, c1, thr3, thr4, width: int, origin: int):
    """The numpy form's ``half`` in plain torch ops on the packed boards ``x``
    (int32[..., H, ceil(W/32)], the bit patterns of the uint32 words), one
    or a batch: ``k0``/``k1`` the key halves, ``c1`` the counter word,
    ``thr3``/``thr4`` the table's entries 3 and 4, each an int32 Python
    int or an int32 tensor broadcasting against ``x`` ([S, 1, 1]: one a
    slot).  Returns a new tensor.

    The column shifts carry one bit across words: the word left of word 0
    is the row's last, whose column W-1 sits at bit ``top`` of the last
    word when W % 32 is not 0 — the seam is at W, not at 32 * ceil(W/32).
    """
    *lead, h, wp = x.shape
    w = int(width)
    rem = w % WORD
    top = (rem or WORD) - 1  # bit index of column w-1 in the last word
    srl = prng._srl
    up = torch.roll(x, -1, -2)
    down = torch.roll(x, 1, -2)
    # L[c] = x[(c-1) mod w]: word j takes bit 31 of word j-1, word 0 the
    # row's column w-1
    carry = srl(torch.roll(x, 1, -1), 31)
    carry[..., 0] = (x[..., -1] >> top) & 1
    left = (x << 1) | carry
    # R[c] = x[(c+1) mod w]: word j takes bit 0 of word j+1, the last word
    # (at bit ``top``) the row's column 0
    right = srl(x, 1) | (torch.roll(x, -1, -1) << 31)
    right[..., -1] = srl(x[..., -1], 1) | ((x[..., 0] & 1) << top)
    s1 = up ^ down ^ left
    c1_ = (up & down) | ((up ^ down) & left)
    b0 = s1 ^ right
    c2 = s1 & right
    b1 = c1_ ^ c2
    b2 = c1_ & c2
    n3 = b0 & b1 & ~b2
    n1 = b0 & ~b1 & ~b2
    n0 = ~(b0 | b1 | b2)
    needs3 = (x & n3) | (~x & n1)
    needs4 = (x & b2) | (~x & n0)
    # the active cells' draws, compacted row-wise as _parity_draw_coords
    # lays them out (padding entries repeat the row's last active index)
    dev = x.device
    half_words = WORD // 2
    rows = torch.arange(h, dtype=torch.int64, device=dev)
    row_off = (rows + parity) & 1
    k = torch.clamp(torch.arange(wp * half_words, dtype=torch.int64, device=dev), max=w // 2 - 1)
    idx = rows[:, None] * w + row_off[:, None] + 2 * k[None, :] + int(origin)
    lo, hi = prng.split_cell_index_torch(idx)
    if int(origin) + h * w > prng.MAX_NARROW_CELLS:
        k0, k1 = prng.derive_wide_keys_torch(k0, k1, hi)
    u = prng.threefry2x32_torch(k0, k1, lo, c1)[0]
    weights = torch.tensor([1 << (2 * t) for t in range(half_words)], dtype=torch.int32, device=dev)
    shift = row_off.to(torch.int32)[:, None]

    def spread(bits: torch.Tensor) -> torch.Tensor:
        words = bits.reshape(*bits.shape[:-1], wp, half_words).to(torch.int32) * weights
        words = words.sum(-1, dtype=torch.int32)
        return words << shift

    cmp3 = spread(prng.ult(u, thr3))
    cmp4 = spread(prng.ult(u, thr4))
    accept = ~(needs3 | needs4) | (needs3 & cmp3) | (needs4 & cmp4)
    pmask = torch.where(row_off == 1, prng.as_i32(0xAAAAAAAA), prng.as_i32(0x55555555))
    cmask = torch.from_numpy(column_mask(w).view(np.int32)).to(dev)
    flip_mask = pmask.to(torch.int32)[:, None] & cmask[None, :]
    return x ^ (accept & flip_mask)


def half_sweep_torch(
    x: torch.Tensor, parity: int, k0: int, k1: int, step: int, thr3: int, thr4: int, *,
    width: int, origin: int = 0,
) -> torch.Tensor:
    """One checkerboard half-sweep of the packed board ``x`` (int32[H,
    ceil(W/32)], the bit patterns of the uint32 words) on its device: the
    numpy form's ``half`` in plain torch ops.  ``k0``/``k1`` are the run's
    key halves, ``step`` the absolute sweep, ``thr3``/``thr4`` the
    acceptance table's entries 3 and 4 (uint32 values or their int32 bit
    patterns), ``origin`` the flat index of cell (0, 0).  Returns a new
    tensor."""
    substream = prng.SUB_ODD if parity else prng.SUB_EVEN
    return _half_sweep_words(x, parity, prng.as_i32(k0), prng.as_i32(k1),
                             prng.as_i32(prng.counter_word(step, substream)), prng.as_i32(thr3),
                             prng.as_i32(thr4), width, origin)


def half_sweep_batch_torch(
    x: torch.Tensor, parity: int, state: prng.SlotState, *, width: int, offset: int = 0,
    origin: int = 0,
) -> torch.Tensor:
    """The plain version of K6's batch mode: :func:`half_sweep_torch` of each
    live slot of the packed batch ``x`` (int32[S, H, ceil(W/32)]) at sweep
    ``offset`` of the chunk — under the slot's key, at counter
    ``state.counter + offset``, against its table's entries 3 and 4 — and a
    frozen slot (``state.rem <= offset``) as it was, the port's form of the
    JAX package's vmapped half-sweep under its freeze mask.  Returns a new
    tensor."""
    substream = prng.SUB_ODD if parity else prng.SUB_EVEN

    def per_slot(t: torch.Tensor) -> torch.Tensor:
        return t.view(-1, 1, 1)

    stepped = _half_sweep_words(x, parity, per_slot(state.k0), per_slot(state.k1),
                                state.counter_words(offset, substream),
                                per_slot(state.thr[:, 3]), per_slot(state.thr[:, 4]), width,
                                origin)
    return torch.where(state.live(offset), stepped, x)


def make_sweep(xp, rule: Rule, shape: tuple[int, int], *, origin: int = 0):
    """One full packed Metropolis sweep as ``fn(x, k0, k1, step, thr)``.

    ``xp`` is numpy (``x`` the uint32[h, ceil(w/32)] bitboard;
    ``k0``/``k1``/``step`` uint32 scalars; ``thr`` the uint32[5] table from
    ``ising.acceptance_thresholds``) or torch (``x`` its int32 view as a
    tensor; ``step`` a Python int; two :func:`half_sweep_torch` calls).
    Bit-identical to ``ising.sweep`` on the unpacked board.  ``origin``
    places the board in the 64-bit cell-index space; 0 is the whole-board
    narrow default.
    """
    if not supports(rule):
        raise ValueError(
            f"packed Metropolis supports the ising rule family only, got {rule}"
        )
    h, w = int(shape[0]), int(shape[1])
    validate_board_shape(rule, (h, w), wide_counter=True)
    if xp is np:
        return _make_sweep_np(rule, (h, w), int(origin))

    def sweep(x, k0, k1, step, thr):
        for parity in (0, 1):
            x = half_sweep_torch(x, parity, k0, k1, step, int(thr[3]), int(thr[4]),
                                 width=w, origin=origin)
        return x

    return sweep


def run_packed_np(
    rule: Rule,
    board: np.ndarray,
    seed: int,
    steps: int,
    *,
    temperature: float,
    start_step: int = 0,
) -> np.ndarray:
    """``steps`` packed ground-truth NumPy sweeps from ``start_step`` —
    the packed twin of ``mc.run_np``, returning the unpacked board."""
    from tpu_life_torch.mc import ising

    k0, k1 = prng.key_halves(seed)
    thr = ising.acceptance_thresholds(temperature)
    board = np.asarray(board, np.int8)
    fn = make_sweep(np, rule, board.shape)
    x = pack_board(board)
    for i in range(steps):
        x = fn(x, np.uint32(k0), np.uint32(k1), np.uint32(start_step + i), thr)
    return unpack_board(x, board.shape[1])
