"""Counter-based PRNG: Threefry-2x32 keyed by (seed, step, cell, substream).

A trimmed copy of ``tpu_life/mc/prng.py``: what :func:`seeded_board` needs,
on numpy only (the JAX package stages its seeded boards on the host with
numpy too, so the bytes match by construction).  Every draw is a pure
function of its coordinates: the draw for cell ``(r, c)`` at step ``s`` in
substream ``m`` of a run seeded ``S`` is::

    u32 = threefry2x32(key=(S_lo, S_hi), counter=(r*w + c, s*NSUB + m))[0]

The same Threefry-2x32/20 as ``jax._src.prng.threefry_2x32``.  A torch or
device twin for the stochastic tier is not ported yet.
"""

from __future__ import annotations

import numpy as np

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

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def _rotl(x, r: int):
    r = np.uint32(r)
    return (x << r) | (x >> (np.uint32(32) - r))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds: counter ``(c0, c1)`` under key ``(k0, k1)``.

    All inputs are uint32 (scalars or arrays; ``c0``/``c1`` broadcast);
    returns the two uint32 output words.
    """
    # wraparound is the algorithm; numpy warns on *scalar* uint32 overflow
    with np.errstate(over="ignore"):
        k0 = np.uint32(k0)
        k1 = np.uint32(k1)
        ks2 = k0 ^ k1 ^ np.uint32(0x1BD11BDA)
        x0 = np.asarray(c0, dtype=np.uint32) + k0
        x1 = np.asarray(c1, dtype=np.uint32) + k1
        keys = (k0, k1, ks2)
        for group in range(5):
            for r in _ROT_A if group % 2 == 0 else _ROT_B:
                x0 = x0 + x1
                x1 = _rotl(x1, r)
                x1 = x1 ^ x0
            x0 = x0 + keys[(group + 1) % 3]
            x1 = x1 + keys[(group + 2) % 3] + np.uint32(group + 1)
        return x0, x1


def key_halves(seed: int) -> tuple[int, int]:
    """Split a Python-int seed into the (lo, hi) uint32 key words
    (two's complement of the low 64 bits: ``seed=-1`` is a valid stream)."""
    seed = int(seed)
    return seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF


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


def threshold_u32(p: float) -> int:
    """``p`` in [0, 1] -> the uint32 threshold t with P(u < t) ~= p
    (p <= 0 -> 0; p >= 1 -> callers branch)."""
    if p <= 0.0:
        return 0
    return min(0xFFFFFFFF, int(float(p) * 4294967296.0))


def seeded_board(
    height: int,
    width: int,
    density: float = 0.5,
    *,
    states: int = 2,
    seed: int = 0,
) -> np.ndarray:
    """A seeded random board from the counter-based stream (int8), the
    board ``run --size N --steps S --seed X`` stages where no input file
    exists.  Uses ``SUB_BOARD`` at step 0; a multi-state board draws each
    live cell's state from word 1 at counter word ``NSUB + SUB_BOARD``."""
    if not 0.0 <= density <= 1.0:
        raise ValueError(f"density must be in [0, 1], got {density}")
    if states < 2:
        raise ValueError(f"states must be >= 2, got {states}")
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
