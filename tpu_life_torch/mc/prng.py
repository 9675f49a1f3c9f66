"""Counter-based PRNG: Threefry-2x32 keyed by (seed, step, cell, substream).

A trimmed copy of ``tpu_life/mc/prng.py``: what :func:`seeded_board` needs,
on numpy only (the JAX package stages its seeded boards on the host with
numpy too, so the bytes match by construction).  Every draw is a pure
function of its coordinates: the draw for cell ``(r, c)`` at step ``s`` in
substream ``m`` of a run seeded ``S`` is::

    u32 = threefry2x32(key=(S_lo, S_hi), counter=(r*w + c, s*NSUB + m))[0]

The same Threefry-2x32/20 as ``jax._src.prng.threefry_2x32``.

Below the numpy functions sits their torch twin (``*_torch``), the plain
version of kernel K7 (``kernels.mc_threefry.cell_uniforms``): the same
hash on int32 tensors holding uint32 bit patterns, on any device.  Torch
on the CPU has no uint32 shifts or comparisons, so the twin works on int32
views: addition wraps alike, a logical right shift masks the sign bits
away (:func:`_srl`) and an unsigned comparison flips the sign bit first
(:func:`ult`).  Python ints crossing into it are taken mod 2^32 and passed
as the int32 of their bit pattern (:func:`as_i32`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# the torch-free numpy hash, re-exported here
from tpu_life_torch.utils.threefry import _ROT_A, _ROT_B, _rotl, key_halves, threefry2x32, threshold_u32  # noqa: F401

#: Substream ids — one per independent draw family at the same (cell, step).
SUB_EVEN = 0  # checkerboard half-sweep, parity 0
SUB_ODD = 1  # checkerboard half-sweep, parity 1
SUB_NOISE = 2  # noisy-Life flip mask
SUB_BOARD = 3  # seeded initial-board staging
NSUB = 4

#: Cells addressable by the narrow (one-word) schedule: flat indices
#: 0 .. 2^32 - 1 fit a single uint32 counter word.  Bigger boards go
#: through the wide (two-word) cell index below.
MAX_NARROW_CELLS = 1 << 32

#: The c1 word of the wide-index key-derivation hash; simulation draws
#: reach it only at step ~1.07e9.
WIDE_KEY_TAG = 0xFFFFFFFF


def split_cell_index(idx) -> tuple[np.ndarray, np.ndarray]:
    """64-bit flat cell indices -> ``(lo, hi)`` uint32 word arrays."""
    idx = np.asarray(idx, np.int64)
    if idx.size and int(idx.min()) < 0:
        raise ValueError("cell indices must be >= 0")
    return (idx & 0xFFFFFFFF).astype(np.uint32), (idx >> 32).astype(np.uint32)


def derive_wide_keys(k0, k1, hi):
    """Per-cell ``(k0', k1')`` for the two-word cell index: block 0
    (``hi == 0``) keeps the run key verbatim, blocks ``hi > 0`` re-key
    through one Threefry evaluation on counter ``(hi, WIDE_KEY_TAG)``."""
    d0, d1 = threefry2x32(k0, k1, hi, np.uint32(WIDE_KEY_TAG))
    narrow = np.asarray(hi, dtype=np.uint32) == np.uint32(0)
    return np.where(narrow, np.uint32(k0), d0), np.where(narrow, np.uint32(k1), d1)


def cell_uniforms_at(lo, hi, k0, k1, step, substream: int):
    """uint32 draws at explicit two-word cell coordinates ``(hi, lo)``;
    ``hi = None`` selects the narrow schedule outright."""
    c1 = np.uint32(step) * np.uint32(NSUB) + np.uint32(substream)
    if hi is None:
        u, _ = threefry2x32(k0, k1, lo, c1)
        return u
    wk0, wk1 = derive_wide_keys(k0, k1, hi)
    u, _ = threefry2x32(wk0, wk1, lo, c1)
    return u


def cell_uniforms(shape: tuple[int, int], k0, k1, step, substream: int, *, origin: int = 0):
    """uint32[h, w] of i.i.d. draws for every cell at ``step``/``substream``;
    ``origin`` is the absolute flat index of element (0, 0)."""
    h, w = shape
    n = h * w
    origin = int(origin)
    if origin < 0:
        raise ValueError(f"origin must be >= 0, got {origin}")
    if n > MAX_NARROW_CELLS:
        raise ValueError(
            f"cannot materialize draws for {n} cells in one array; "
            f"address a mega-board shard-wise via origin"
        )
    c1 = np.uint32(step) * np.uint32(NSUB) + np.uint32(substream)
    if origin == 0:
        c0 = np.arange(n, dtype=np.uint32).reshape(h, w)
        u, _ = threefry2x32(k0, k1, c0, c1)
        return u
    base_lo = np.uint32(origin & 0xFFFFFFFF)
    base_hi = np.uint32((origin >> 32) & 0xFFFFFFFF)
    off = np.arange(n, dtype=np.uint32).reshape(h, w)
    with np.errstate(over="ignore"):
        lo = base_lo + off  # wraps mod 2^32
        # off < 2^32, so at most one carry: it happened iff the sum wrapped
        hi = base_hi + (lo < base_lo).astype(np.uint32)
    if origin + n <= MAX_NARROW_CELLS:
        hi = None  # still inside block 0: narrow schedule
    return cell_uniforms_at(lo, hi, k0, k1, step, substream)


def seeded_board(
    height: int,
    width: int,
    density: float = 0.5,
    *,
    states: int = 2,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> np.ndarray | torch.Tensor:
    """A seeded random board from the counter-based stream (int8), the
    board ``run --size N --steps S --seed X`` stages where no input file
    exists.  Uses ``SUB_BOARD`` at step 0; a multi-state board draws each
    live cell's state from word 1 at counter word ``NSUB + SUB_BOARD``.

    With ``device`` the same board is drawn there and returned as an int8
    tensor on it: through kernel K7 on a CUDA device, its plain version on
    the CPU."""
    if not 0.0 <= density <= 1.0:
        raise ValueError(f"density must be in [0, 1], got {density}")
    if states < 2:
        raise ValueError(f"states must be >= 2, got {states}")
    if device is not None:
        return _seeded_board_torch(height, width, density, states=states, seed=seed,
                                   device=torch.device(device))
    k0, k1 = key_halves(seed)
    u = cell_uniforms((height, width), k0, k1, np.uint32(0), SUB_BOARD)
    if density >= 1.0:
        alive = np.ones((height, width), dtype=bool)
    else:
        alive = u < np.uint32(threshold_u32(density))
    if states == 2:
        return alive.astype(np.int8)
    _, u2 = threefry2x32(
        k0,
        k1,
        np.arange(height * width, dtype=np.uint32).reshape(height, width),
        np.uint32(1) * np.uint32(NSUB) + np.uint32(SUB_BOARD),
    )
    state = (u2 % np.uint32(states - 1)).astype(np.int8) + np.int8(1)
    return np.where(alive, state, np.int8(0)).astype(np.int8)


# -- the torch twin: int32 tensors of uint32 bit patterns ---------------------

INT32_MIN = -(1 << 31)


def as_i32(v: int) -> int:
    """The int32 of the bit pattern of ``v mod 2^32`` (a Python int)."""
    v = int(v) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def as_u32(v: int) -> int:
    """The uint32 value of an int32 bit pattern (a Python int)."""
    return int(v) & 0xFFFFFFFF


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns by ``k`` in 1..31."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned ``a < b`` of int32 bit patterns (``b`` a tensor or an int32
    Python int): flipping the sign bit maps unsigned order onto signed."""
    return (a ^ INT32_MIN) < (b ^ INT32_MIN)


def _key(k):
    """A key word as the hash takes it: a tensor as it is, an int as int32."""
    return k if isinstance(k, torch.Tensor) else as_i32(k)


def threefry2x32_torch(k0, k1, c0, c1) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` on int32 tensors: keys and counters are int32
    tensors (broadcasting) or Python ints taken mod 2^32; at least one
    counter is a tensor.  Returns the two output words as int32 tensors."""
    k0, k1 = _key(k0), _key(k1)
    ks2 = k0 ^ k1 ^ as_i32(0x1BD11BDA)  # int32 operands keep an int32 xor
    device = next(c.device for c in (c0, c1) if isinstance(c, torch.Tensor))
    c0, c1 = (
        c if isinstance(c, torch.Tensor)
        else torch.tensor(as_i32(c), dtype=torch.int32, device=device)
        for c in (c0, c1)
    )
    x0 = c0 + k0
    x1 = c1 + k1
    keys = (k0, k1, ks2)
    for group in range(5):
        for r in _ROT_A if group % 2 == 0 else _ROT_B:
            x0 = x0 + x1
            x1 = (x1 << r) | _srl(x1, 32 - r)
            x1 = x1 ^ x0
        x0 = x0 + keys[(group + 1) % 3]
        x1 = x1 + keys[(group + 2) % 3] + (group + 1)
    return x0, x1


def split_cell_index_torch(idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 flat cell indices -> ``(lo, hi)`` int32 word tensors."""
    if idx.numel() and int(idx.min()) < 0:
        raise ValueError("cell indices must be >= 0")
    return (idx & 0xFFFFFFFF).to(torch.int32), (idx >> 32).to(torch.int32)


def derive_wide_keys_torch(k0, k1, hi: torch.Tensor):
    """:func:`derive_wide_keys` on int32 tensors: block 0 keeps the run key,
    blocks ``hi > 0`` re-key through Threefry at ``(hi, WIDE_KEY_TAG)``."""
    d0, d1 = threefry2x32_torch(k0, k1, hi, WIDE_KEY_TAG)
    narrow = hi == 0
    return torch.where(narrow, _key(k0), d0), torch.where(narrow, _key(k1), d1)


def counter_word(step: int, substream: int) -> int:
    """The counter's second word, ``step * NSUB + substream`` mod 2^32."""
    return (int(step) * NSUB + int(substream)) & 0xFFFFFFFF


class SlotState(NamedTuple):
    """The per-slot state of a batch of S boards of the stochastic serving
    engines, int32 tensors of the uint32 values' bit patterns on the
    boards' device: the key halves ``k0`` and ``k1`` [S], the absolute
    sweep ``counter`` [S] at the chunk's start, the acceptance table ``thr``
    [S, 5] (zeros for noisy rules) and the budget ``rem`` [S] left at the
    chunk's start.  A slot is live for the sweeps ``offset < rem`` of the
    chunk; sweep ``offset`` of a live slot draws at counter ``counter +
    offset`` (the JAX package's counter, which advances only while its slot
    is live)."""

    k0: torch.Tensor
    k1: torch.Tensor
    counter: torch.Tensor
    thr: torch.Tensor
    rem: torch.Tensor

    def live(self, offset: int) -> torch.Tensor:
        """bool[S, 1, 1]: the slots that step at sweep ``offset`` of the
        chunk."""
        return (self.rem > offset).view(-1, 1, 1)

    def counter_words(self, offset: int, substream: int) -> torch.Tensor:
        """int32[S, 1, 1]: each slot's counter word at sweep ``offset``,
        :func:`counter_word` of ``counter + offset`` (mod 2^32, as int32
        arithmetic wraps)."""
        return ((self.counter + offset) * NSUB + substream).view(-1, 1, 1)


def cell_uniforms_at_torch(lo, hi, k0, k1, step: int, substream: int, word: int = 0):
    """:func:`cell_uniforms_at` on int32 tensors: output ``word`` of the
    hash (0, the draw; 1, as seeded staging reads it) at two-word cell
    coordinates ``(hi, lo)``; ``hi = None`` selects the narrow schedule."""
    c1 = counter_word(step, substream)
    if hi is not None:
        k0, k1 = derive_wide_keys_torch(k0, k1, hi)
    return threefry2x32_torch(k0, k1, lo, c1)[word]


def check_block(n: int, origin: int) -> None:
    """The limits of one block of draws, as :func:`cell_uniforms` checks
    them: a non-negative origin and at most 2^32 cells."""
    if origin < 0:
        raise ValueError(f"origin must be >= 0, got {origin}")
    if n > MAX_NARROW_CELLS:
        raise ValueError(
            f"cannot materialize draws for {n} cells in one array; "
            f"address a mega-board shard-wise via origin"
        )


def cell_uniforms_torch(
    shape: tuple[int, int], k0, k1, step: int, substream: int, *, origin: int = 0,
    device: str | torch.device = "cpu", word: int = 0,
) -> torch.Tensor:
    """:func:`cell_uniforms` on the torch device, the plain version of kernel
    K7: output ``word`` of the hash (0, the uint32 draws) for every cell of
    an ``[h, w]`` block at ``step``/``substream``, as int32 bit patterns on
    ``device``.  ``origin`` is the absolute flat index of element (0, 0);
    the 64-bit index ``origin + r*w + c`` splits into the two counter words,
    and blocks past the first 2^32 cells take derived keys, exactly as
    :func:`cell_uniforms` (which any block inside the first 2^32 cells
    reproduces on the narrow schedule)."""
    h, w = shape
    n = h * w
    origin = int(origin)
    check_block(n, origin)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(h, w) + origin
    lo, hi = split_cell_index_torch(idx)
    return cell_uniforms_at_torch(
        lo, None if origin + n <= MAX_NARROW_CELLS else hi, k0, k1, step, substream, word
    )


def cell_uniforms_batch_torch(
    shape: tuple[int, int], state: SlotState, substream: int, *, offset: int = 0,
) -> torch.Tensor:
    """The plain version of K7's batch mode, on the state's device: word 0
    of the hash for every cell of each slot's ``[h, w]`` board (flat index
    ``r*w + c``, the narrow schedule) at sweep ``offset`` of the chunk in
    ``substream``, under each slot's key and counter — ``cell_uniforms``
    of each live slot, zeros for a frozen one.  int32[S, h, w]."""
    h, w = shape
    check_block(h * w, 0)
    idx = torch.arange(h * w, dtype=torch.int64, device=state.rem.device).reshape(h, w)
    lo, _ = split_cell_index_torch(idx)
    k0, k1 = state.k0.view(-1, 1, 1), state.k1.view(-1, 1, 1)
    u = threefry2x32_torch(k0, k1, lo, state.counter_words(offset, substream))[0]
    return torch.where(state.live(offset), u, torch.zeros_like(u))


def _seeded_board_torch(
    height: int, width: int, density: float = 0.5, *, states: int = 2, seed: int = 0,
    device: torch.device,
) -> torch.Tensor:
    """:func:`seeded_board`'s board drawn on ``device`` (an int8 tensor
    there): the alive mask from word 0 at step 0, a live cell's state from
    word 1 at step 1 of ``SUB_BOARD``, both through kernel K7 on a CUDA
    device and its plain version on the CPU."""
    from tpu_life_torch.kernels.mc_threefry import cell_uniforms

    k0, k1 = key_halves(seed)
    shape = (height, width)
    if density >= 1.0:
        alive = torch.ones(shape, dtype=torch.bool, device=device)
    else:
        u = cell_uniforms(shape, k0, k1, 0, SUB_BOARD, device=device)
        alive = ult(u, as_i32(threshold_u32(density)))
    if states == 2:
        return alive.to(torch.int8)
    u2 = cell_uniforms(shape, k0, k1, 1, SUB_BOARD, device=device, word=1)
    state = ((u2.to(torch.int64) & 0xFFFFFFFF) % (states - 1) + 1).to(torch.int8)
    return torch.where(alive, state, torch.zeros_like(state))
