"""Bit-sliced Life in plain PyTorch: 32 cells per word, counts as bitplanes.

The part of ``tpu_life/ops/bitlife.py`` the port runs, on torch tensors:
the clamped Moore step, the clamped von Neumann diamond (2 states,
r <= 2) and the life-like torus step, and the masked step at a shard's
row and word offsets.  The clamped steps are the plain versions the
hand-written kernel K1 (``tpu_life_torch/kernels/packed_stripe.py``) is
held to; the torus step runs on the card for the ``cuda`` backend.  Per
shard (``parallel.halo.make_shard_block``) the masked and the torus
steps are the plain version of kernel K3.  All are executors of the
``torch`` backend on any device.

Layout: the ``pack_np`` layout of the JAX package — a board row of W cells
is ``ceil(W/32)`` 32-bit words, column ``c = 32*j + b`` is bit ``b``
(LSB-first) of word ``j``, and the padding bits of a partial last word are
zero.  The words are held as **int32** views of those uint32 words: torch
on the CPU implements no ``>>`` for uint32, so a logical right shift is an
arithmetic one with the sign-extended bits masked off (:func:`_lsr`).

Counting (Moore): vertical 3-row sums as (ones, twos) planes through
carry-save adders, a horizontal 3-column add of those planes giving the
total (center + 8 neighbors, 0..9) as bitplanes b0..b3, then the rule as
the Quine-McCluskey sum of products of ``alive'(b0..b3, x)``
(``tpu_life_torch.ops.boolmin``).  The torus only swaps the shifts for
ones that wrap at the logical width.  The diamond is a stack of 2r+1
horizontal boxes of half-width ``r - |dy|``, all reduced by one carry-save
tree to the raw count's bitplanes, and the rule is the SOP over that count
(``boolmin.membership_rule_sop``).
"""

from __future__ import annotations

import sys
from typing import Callable

import numpy as np
import torch

from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops.boolmin import membership_rule_sop, rule_sop
from tpu_life_torch.utils.padding import ceil_div

WORD = 32
_U1 = np.uint32(1)
_LITTLE = sys.byteorder == "little"
# popcount of every byte value: live_count sums bytes through it
_BYTE_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int64)


def packed_width(width: int) -> int:
    return ceil_div(width, WORD)


def supports_family(rule: Rule) -> bool:
    """Life-like structure (2-state, Moore r=1, no center): the family the
    bitplane adder tree computes, whatever the boundary.  The boundary
    lives in the neighbor-plane shifts plugged into
    :func:`make_total_planes`."""
    return (
        rule.states == 2
        and rule.radius == 1
        and not rule.include_center
        and rule.neighborhood == "moore"
    )


def supports(rule: Rule) -> bool:
    """Life-like rules on the clamped board."""
    return supports_family(rule) and rule.boundary == "clamped"


def supports_torus(rule: Rule) -> bool:
    """Life-like rules on the torus: wrap carries replace the clamped
    shifts' zero fill, at any width."""
    return supports_family(rule) and rule.boundary == "torus"


def diamond_count_max(rule: Rule) -> int:
    """The largest raw count of a von Neumann rule: ``2r(r+1)``, one more
    where the rule counts the center (``M1``)."""
    return 2 * rule.radius * (rule.radius + 1) + (1 if rule.include_center else 0)


def supports_diamond(rule: Rule) -> bool:
    """2-state clamped von Neumann rules whose largest count fits the four
    count planes the SOP applier reads: ``2r(r+1) (+1 with center) <= 15``,
    that is r <= 2.  Larger radii run on the int8 stencil."""
    return (
        rule.states == 2
        and rule.neighborhood == "von_neumann"
        and rule.boundary == "clamped"
        and diamond_count_max(rule) <= 15
    )


# --- pack / unpack (host side, numpy) ------------------------------------------

def pack_np(board: np.ndarray) -> np.ndarray:
    """int8[H, W] -> uint32[H, ceil(W/32)] (LSB-first) of the alive (== 1)
    bits.  ``np.packbits`` LSB-first bytes read as little-endian uint32
    are exactly the word layout; big-endian hosts take the weighted sum."""
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


def unpack_np(packed: np.ndarray, width: int) -> np.ndarray:
    """uint32[H, Wp] -> int8[H, width]."""
    h, wp = packed.shape
    if _LITTLE:
        by = np.ascontiguousarray(packed).view(np.uint8)
        bits = np.unpackbits(by, axis=1, bitorder="little")
        return bits[:, :width].astype(np.int8)
    shifts = np.arange(WORD, dtype=np.uint32)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & _U1
    return bits.reshape(h, wp * WORD)[:, :width].astype(np.int8)


# --- the step (torch, int32 words) -----------------------------------------------

def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 words by ``0 <= k <= 31``."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (WORD - k)) - 1)


def _hshift_left(x: torch.Tensor) -> torch.Tensor:
    """Plane of left neighbors: L[c] = x[c-1]; clamped zero at column 0."""
    carry = torch.nn.functional.pad(x[:, :-1], (1, 0))  # word j-1, zero at j=0
    return (x << 1) | _lsr(carry, WORD - 1)


def _hshift_right(x: torch.Tensor) -> torch.Tensor:
    """Plane of right neighbors: R[c] = x[c+1]; clamped zero at the last word."""
    carry = torch.nn.functional.pad(x[:, 1:], (0, 1))
    return _lsr(x, 1) | (carry << (WORD - 1))


def _vshift(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(up, down) row-neighbor planes, clamped zero at board edges."""
    up = torch.nn.functional.pad(x[1:], (0, 0, 0, 1))  # U[r] = x[r+1]
    down = torch.nn.functional.pad(x[:-1], (0, 0, 1, 0))  # D[r] = x[r-1]
    return up, down


def _csa(a, b, c):
    """Carry-save adder: a+b+c -> (sum bit, carry bit)."""
    ab = a ^ b
    return ab ^ c, (a & b) | (ab & c)


def make_total_planes(
    hshift_left: Callable, hshift_right: Callable, vshift: Callable
) -> Callable:
    """The bitplane counter over pluggable neighbor-plane shifts."""

    def total_planes(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Bitplanes (b0, b1, b2, b3) of total = center + 8 neighbors (0..9)."""
        up, down = vshift(x)
        ones, twos = _csa(up, x, down)  # vertical 3-sum per column, 2-bit
        o_l, o_r = hshift_left(ones), hshift_right(ones)
        t_l, t_r = hshift_left(twos), hshift_right(twos)
        b0, c1 = _csa(o_l, ones, o_r)  # ones-plane horizontal sum
        s1, c2 = _csa(t_l, twos, t_r)  # twos-plane horizontal sum (weight 2)
        b1 = c1 ^ s1  # weight-2 bits
        u2 = c1 & s1  # carry into weight 4
        b2 = c2 ^ u2
        b3 = c2 & u2  # weight 8 (totals 8, 9)
        return b0, b1, b2, b3

    return total_planes


_total_planes = make_total_planes(_hshift_left, _hshift_right, _vshift)


def make_packed_step(
    rule: Rule, total_planes: Callable | None = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """One life-like CA step on a packed bitboard, the rule applied as its
    minimized sum of products.  ``total_planes`` swaps in another bitplane
    counter (the torus one); the default counts with the clamped shifts."""
    if not supports_family(rule):
        raise ValueError(f"bit-sliced path supports life-like rules only, got {rule}")
    if total_planes is None:
        if rule.boundary != "clamped":
            raise ValueError(
                f"the default shifts are clamped: the life-like "
                f"{rule.boundary} rule {rule} needs its own total_planes "
                f"(make_packed_torus_step)"
            )
        total_planes = _total_planes
    sop = rule_sop(rule.birth, rule.survive)

    def step(x: torch.Tensor) -> torch.Tensor:
        planes = total_planes(x)
        # input bits 0..3 = total planes, bit 4 = x
        return _apply_sop(sop, (*planes, x))

    return step


def _apply_sop(
    sop: tuple[tuple[int, int], ...], literals: tuple[torch.Tensor, ...]
) -> torch.Tensor:
    """Evaluate a (mask, value) sum-of-products over literal bitplanes."""
    n = len(literals)
    inverted = [None] * n  # lazily-shared complements
    out = None
    for mask, value in sop:
        term = None
        for bit in range(n):
            if not mask & (1 << bit):
                continue
            if value & (1 << bit):
                lit = literals[bit]
            else:
                if inverted[bit] is None:
                    inverted[bit] = ~literals[bit]
                lit = inverted[bit]
            term = lit if term is None else term & lit
        if term is None:  # (0, 0): constant-true cover
            term = torch.full_like(literals[-1], -1)
        out = term if out is None else out | term
    return torch.zeros_like(literals[-1]) if out is None else out


# --- torus shifts ---------------------------------------------------------------

def column_mask(width: int) -> np.ndarray:
    """uint32[ceil(width/32)] with exactly the valid-column bits set."""
    m = np.full(packed_width(width), 0xFFFFFFFF, np.uint32)
    rem = width % WORD
    if rem:
        m[-1] = np.uint32((1 << rem) - 1)
    return m


def make_torus_hshifts(width: int) -> tuple[Callable, Callable]:
    """(left, right) neighbor-plane shifts that wrap at the logical width.

    The in-word shift and adjacent-word carry of the clamped shifts; at the
    seam the true opposite-edge bit replaces the zero fill.  Column W-1 is
    bit ``rem - 1`` of the last word when the width is not word-aligned, so
    the seam words address that bit.  Inputs must carry zero padding bits
    (``pack_np`` and the column re-mask of every step see to it).  The
    seam words are built beside the input, never written into it.
    """
    wp = packed_width(width)
    rem = width % WORD
    top = (rem or WORD) - 1  # bit index of column width-1 in the last word

    def hshift_left_t(x: torch.Tensor) -> torch.Tensor:
        """L[c] = x[(c-1) mod width]."""
        if wp == 1:
            return (x << 1) | (_lsr(x, top) & 1)
        carry = torch.roll(x, 1, dims=1)  # carry[j] = x[j-1]; [0] = x[wp-1]
        if rem:
            # bit rem-1 of the last word lands at bit 31 of the virtual
            # word left of word 0
            carry = torch.cat([x[:, -1:] << (WORD - rem), carry[:, 1:]], dim=1)
        return (x << 1) | _lsr(carry, WORD - 1)

    def hshift_right_t(x: torch.Tensor) -> torch.Tensor:
        """R[c] = x[(c+1) mod width]."""
        if wp == 1:
            return _lsr(x, 1) | ((x & 1) << top)
        carry = torch.roll(x, -1, dims=1)  # carry[j] = x[j+1]; [wp-1] = x[0]
        out = _lsr(x, 1) | (carry << (WORD - 1))
        if rem:
            # last word: column width-1 (bit rem-1) receives column 0
            last = _lsr(x[:, -1:], 1) | ((x[:, :1] & 1) << top)
            out = torch.cat([out[:, :-1], last], dim=1)
        return out

    return hshift_left_t, hshift_right_t


def _vshift_wrap(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(up, down) row-neighbor planes on the torus: rows wrap."""
    return torch.roll(x, -1, dims=0), torch.roll(x, 1, dims=0)


def make_packed_torus_step(
    rule: Rule, width: int, *, wrap_rows: bool = True
) -> Callable[[torch.Tensor], torch.Tensor]:
    """One life-like step on a packed bitboard with torus boundary.

    ``wrap_rows=False`` keeps the rows clamped while the columns wrap in
    place: the per-shard substep of a sharded torus, whose vertical
    neighbors arrive as halo rows.  Output padding bits are re-masked dead
    every step so they can never feed the seam carries.
    """
    if not supports_torus(rule):
        raise ValueError(
            f"packed torus path supports life-like torus rules only, got {rule}"
        )
    hl, hr = make_torus_hshifts(width)
    step = make_packed_step(
        rule, total_planes=make_total_planes(hl, hr, _vshift_wrap if wrap_rows else _vshift)
    )
    cmask = torch.from_numpy(column_mask(width).view(np.int32))
    masks: dict[torch.device, torch.Tensor] = {}

    def torus_step(x: torch.Tensor) -> torch.Tensor:
        if x.device not in masks:
            masks[x.device] = cmask.to(x.device)[None, :]
        return step(x) & masks[x.device]

    return torus_step


def multi_step_packed_torus(
    x: torch.Tensor, *, rule: Rule, steps: int, width: int
) -> torch.Tensor:
    """``steps`` packed torus steps (single device)."""
    step = make_packed_torus_step(rule, width)
    for _ in range(steps):
        x = step(x)
    return x


# --- bit-sliced von Neumann diamond ---------------------------------------------

def _hshift_left_by(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plane of k-left neighbors: L[c] = x[c-k], clamped zero; 1 <= k < 32."""
    carry = torch.nn.functional.pad(x[:, :-1], (1, 0))
    return (x << k) | _lsr(carry, WORD - k)


def _hshift_right_by(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plane of k-right neighbors: R[c] = x[c+k], clamped zero; 1 <= k < 32."""
    carry = torch.nn.functional.pad(x[:, 1:], (0, 1))
    return _lsr(x, k) | (carry << (WORD - k))


def _vshift_by(x: torch.Tensor, dy: int) -> torch.Tensor:
    """Plane of row neighbors at offset dy: V[r] = x[r+dy], clamped zero."""
    if dy == 0:
        return x
    zeros = min(abs(dy), x.shape[0])  # a board shallower than the shift keeps its height
    if dy > 0:
        return torch.nn.functional.pad(x[dy:], (0, 0, 0, zeros))
    return torch.nn.functional.pad(x[:dy], (0, 0, zeros, 0))


def _reduce_planes(
    weighted: list[tuple[torch.Tensor, int]],
) -> tuple[torch.Tensor, ...]:
    """Carry-save reduce (plane, weight_log2) pairs to the sum's bitplanes
    b0, b1, ...: full adders compress three planes of one weight into a sum
    and a carry of the next weight until every weight holds one plane."""
    levels: dict[int, list[torch.Tensor]] = {}
    for plane, w in weighted:
        levels.setdefault(w, []).append(plane)
    zero = torch.zeros_like(weighted[0][0])
    out: list[torch.Tensor] = []
    w = 0
    while levels:
        cur = levels.pop(w, [])
        while len(cur) >= 3:
            s, carry = _csa(cur.pop(), cur.pop(), cur.pop())
            cur.append(s)
            levels.setdefault(w + 1, []).append(carry)
        if len(cur) == 2:
            a, b = cur
            cur = [a ^ b]
            levels.setdefault(w + 1, []).append(a & b)
        out.append(cur[0] if cur else zero)
        w += 1
    return tuple(out)


def _collapse(
    weighted: list[tuple[torch.Tensor, int]],
) -> list[tuple[torch.Tensor, int]]:
    """Carry-save compress a small (plane, weight) list without finalizing:
    keeps a box sum narrow before it fans out per row."""
    return [(p, w) for w, p in enumerate(_reduce_planes(weighted))]


def make_packed_diamond_step(rule: Rule) -> Callable[[torch.Tensor], torch.Tensor]:
    """One 2-state von Neumann step on a packed bitboard (clamped).

    The diamond is a stack of 2r+1 horizontal boxes of half-width
    ``r - |dy|``.  The box planes of the center row are built once per
    half-width; each ``|dy| > 0`` row reuses the box of its half-width,
    row-shifted; the ``dy = 0`` row gives its left and right arms, and the
    center only for ``M1`` rules.  One carry-save reduction turns all of
    them into the raw count's bitplanes, and the rule is the SOP over that
    count with the center as the literal after the last plane.
    """
    if not supports_diamond(rule):
        raise ValueError(
            f"packed diamond path needs a 2-state clamped von Neumann rule "
            f"with count_max <= 15, got {rule}"
        )
    r = rule.radius
    nplanes, sop = membership_rule_sop(rule.birth, rule.survive, diamond_count_max(rule))

    def step(x: torch.Tensor) -> torch.Tensor:
        # box[h] sums columns c-h..c+h of x as (plane, weight) pairs
        box: dict[int, list[tuple[torch.Tensor, int]]] = {0: [(x, 0)]}
        arms: list[tuple[torch.Tensor, int]] = []  # L/R shifts, no center
        for k in range(1, r + 1):
            arms.append((_hshift_left_by(x, k), 0))
            arms.append((_hshift_right_by(x, k), 0))
            if k < r:  # rows use half-widths <= r-1
                box[k] = _collapse(box[k - 1] + arms[-2:])
        weighted: list[tuple[torch.Tensor, int]] = []
        for dy in range(-r, r + 1):
            if dy == 0:
                weighted.extend(arms)
                if rule.include_center:
                    weighted.append((x, 0))
            else:
                weighted.extend((_vshift_by(p, dy), w) for p, w in box[r - abs(dy)])
        planes = _reduce_planes(weighted)
        planes = planes[:nplanes] + (torch.zeros_like(x),) * max(0, nplanes - len(planes))
        return _apply_sop(sop, (*planes, x))

    return step


def word_mask(
    shape: tuple[int, int],
    logical_shape: tuple[int, int],
    device,
    row_offset: int = 0,
    word_offset: int = 0,
) -> torch.Tensor:
    """int32[H, Wp] with exactly the in-board bits set, where physical
    row 0 is global row ``row_offset`` and word column 0 is global word
    ``word_offset``: rows in ``[0, lh)``, whole words in ``[0, lw // 32)``
    and the low ``lw % 32`` bits of the partial last word.  Negative rows
    and words (a halo above or left of the board) are dead."""
    h, wp = shape
    lh, lw = logical_shape
    full, rem = divmod(lw, WORD)
    gw = word_offset + np.arange(wp)
    cols = np.where(gw < full, np.uint32(0xFFFFFFFF), np.uint32(0))
    if rem:
        cols[gw == full] = (1 << rem) - 1
    cols[gw < 0] = 0
    cols = torch.from_numpy(cols.astype(np.uint32).view(np.int32)).to(device)
    rows = row_offset + torch.arange(h, device=device)
    rows_ok = (rows >= 0) & (rows < lh)
    return torch.where(rows_ok[:, None], cols[None, :], torch.zeros_like(cols[:1]))


def make_masked_packed_step(
    rule: Rule, logical_shape: tuple[int, int], step: Callable | None = None
) -> Callable[..., torch.Tensor]:
    """Packed step that pins cells outside the logical board dead.

    ``masked(x, row_offset=0, word_offset=0)``: ``row_offset`` is the
    global row of ``x``'s row 0 and ``word_offset`` the global word of its
    word column 0 (a shard's halo-extended chunk starts above the board's
    row 0 or inside it).  Rows outside ``[0, lh)``, words outside the
    board and the padding bits of the partial last word are pinned dead.
    ``step`` is the unmasked packed step; by default von Neumann rules get
    the bit-sliced diamond and every other rule the life-like Moore step,
    so every caller of the masked step runs diamonds with no dispatch of
    its own."""
    if step is None:
        step = (
            make_packed_diamond_step(rule)
            if rule.neighborhood == "von_neumann"
            else make_packed_step(rule)
        )
    masks: dict[tuple, torch.Tensor] = {}

    def masked(x: torch.Tensor, row_offset: int = 0, word_offset: int = 0) -> torch.Tensor:
        key = (tuple(x.shape), x.device, int(row_offset), int(word_offset))
        if key not in masks:
            masks[key] = word_mask(
                tuple(x.shape), logical_shape, x.device, int(row_offset), int(word_offset)
            )
        return step(x) & masks[key]

    return masked


def multi_step_packed(
    x: torch.Tensor,
    *,
    rule: Rule,
    steps: int,
    logical_shape: tuple[int, int],
) -> torch.Tensor:
    """``steps`` masked bit-sliced CA steps (packed domain, clamped): the
    Moore step for life-like rules, the diamond for von Neumann rules."""
    masked = make_masked_packed_step(rule, tuple(logical_shape))
    for _ in range(steps):
        x = masked(x)
    return x


def multi_step_packed_diamond(
    x: torch.Tensor,
    *,
    rule: Rule,
    steps: int,
    logical_shape: tuple[int, int],
) -> torch.Tensor:
    """``steps`` masked packed diamond steps (clamped)."""
    masked = make_masked_packed_step(
        rule, tuple(logical_shape), step=make_packed_diamond_step(rule)
    )
    for _ in range(steps):
        x = masked(x)
    return x


def live_count_packed(x: torch.Tensor) -> torch.Tensor:
    """Live-cell count of a packed bitboard as an int64 scalar tensor on
    ``x``'s device: a histogram of its bytes weighted by each byte's
    popcount (torch has no popcount), exact at any board size."""
    hist = torch.bincount(x.contiguous().view(torch.uint8).flatten(), minlength=256)
    return (hist * _BYTE_POPCOUNT.to(x.device)).sum()
