"""Threefry-2x32 on numpy: the hash, the key split and the rate threshold.

The numpy half of :mod:`tpu_life_torch.mc.prng` that imports no torch, so
the chaos seams (``tpu_life_torch.chaos``) and the processes built on them
(the HTTP spill store, the gateway client) start without loading torch.
``mc.prng`` re-exports every name here; the functions are copies of
``tpu_life/mc/prng.py``'s.
"""

from __future__ import annotations

import numpy as np

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


def threshold_u32(p: float) -> int:
    """``p`` in [0, 1] -> the uint32 threshold t with P(u < t) ~= p
    (p <= 0 -> 0; p >= 1 -> callers branch)."""
    if p <= 0.0:
        return 0
    return min(0xFFFFFFFF, int(float(p) * 4294967296.0))
