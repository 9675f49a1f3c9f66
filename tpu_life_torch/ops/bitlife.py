"""Bit-sliced Life in plain PyTorch: 32 cells per word, counts as bitplanes.

The clamped Moore part of ``tpu_life/ops/bitlife.py`` on torch tensors.
It is the plain version the hand-written kernel
(``tpu_life_torch/kernels/packed_stripe.py``) is held to, and the
executor of the ``torch`` backend on any device.

Layout: the ``pack_np`` layout of the JAX package — a board row of W cells
is ``ceil(W/32)`` 32-bit words, column ``c = 32*j + b`` is bit ``b``
(LSB-first) of word ``j``, and the padding bits of a partial last word are
zero.  The words are held as **int32** views of those uint32 words: torch
on the CPU implements no ``>>`` for uint32, so a logical right shift is an
arithmetic one with the sign-extended bits masked off (:func:`_lsr`).

Counting: vertical 3-row sums as (ones, twos) planes through carry-save
adders, a horizontal 3-column add of those planes giving the total
(center + 8 neighbors, 0..9) as bitplanes b0..b3, then the rule as the
Quine-McCluskey sum of products of ``alive'(b0..b3, x)``
(``tpu_life_torch.ops.boolmin``).
"""

from __future__ import annotations

import sys
from typing import Callable

import numpy as np
import torch

from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops.boolmin import rule_sop
from tpu_life_torch.utils.padding import ceil_div

WORD = 32
_U1 = np.uint32(1)
_LITTLE = sys.byteorder == "little"
# popcount of every byte value: live_count sums bytes through it
_BYTE_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int64)


def packed_width(width: int) -> int:
    return ceil_div(width, WORD)


def supports(rule: Rule) -> bool:
    """Life-like rules (2-state, Moore r=1, no center) on the clamped
    board: the family the bitplane adder tree computes."""
    return (
        rule.states == 2
        and rule.radius == 1
        and not rule.include_center
        and rule.neighborhood == "moore"
        and rule.boundary == "clamped"
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
    """Logical right shift of int32 words by ``1 <= k <= 31``."""
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


def make_packed_step(rule: Rule) -> Callable[[torch.Tensor], torch.Tensor]:
    """One life-like CA step on a packed bitboard (clamped boundary), the
    rule applied as its minimized sum of products."""
    if not supports(rule):
        raise ValueError(
            f"bit-sliced path supports clamped life-like rules only, got {rule}"
        )
    sop = rule_sop(rule.birth, rule.survive)

    def step(x: torch.Tensor) -> torch.Tensor:
        planes = _total_planes(x)
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


def word_mask(
    shape: tuple[int, int], logical_shape: tuple[int, int], device
) -> torch.Tensor:
    """int32[H, Wp] with exactly the in-board bits set: rows below ``lh``,
    whole words below ``lw // 32``, and the low ``lw % 32`` bits of the
    partial last word."""
    h, wp = shape
    lh, lw = logical_shape
    full, rem = divmod(lw, WORD)
    cols = np.zeros(wp, np.uint32)
    cols[: min(full, wp)] = 0xFFFFFFFF
    if rem and full < wp:
        cols[full] = (1 << rem) - 1
    cols = torch.from_numpy(cols.view(np.int32)).to(device)
    rows = torch.arange(h, device=device) < lh
    return torch.where(rows[:, None], cols[None, :], torch.zeros_like(cols[:1]))


def make_masked_packed_step(
    rule: Rule, logical_shape: tuple[int, int]
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Packed step that pins cells outside the logical board dead: rows at
    or past ``lh`` and the padding bits of the partial last word."""
    step = make_packed_step(rule)
    masks: dict[tuple, torch.Tensor] = {}

    def masked(x: torch.Tensor) -> torch.Tensor:
        key = (tuple(x.shape), x.device)
        if key not in masks:
            masks[key] = word_mask(tuple(x.shape), logical_shape, x.device)
        return step(x) & masks[key]

    return masked


def multi_step_packed(
    x: torch.Tensor,
    *,
    rule: Rule,
    steps: int,
    logical_shape: tuple[int, int],
) -> torch.Tensor:
    """``steps`` masked bit-sliced CA steps (packed domain)."""
    masked = make_masked_packed_step(rule, tuple(logical_shape))
    for _ in range(steps):
        x = masked(x)
    return x


def live_count_packed(x: torch.Tensor) -> torch.Tensor:
    """Live-cell count of a packed bitboard as an int64 scalar tensor on
    ``x``'s device: a histogram of its bytes weighted by each byte's
    popcount (torch has no popcount), exact at any board size."""
    hist = torch.bincount(x.contiguous().view(torch.uint8).flatten(), minlength=256)
    return (hist * _BYTE_POPCOUNT.to(x.device)).sum()
