"""Threefry-2x32 in plain PyTorch, on int32 tensors that hold uint32 bit
patterns.

A frozen copy of the stream the Ising configuration states (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011; the same function
as ``jax.random``'s ``threefry_2x32``): key ``(k0, k1)``, counter
``(c0, c1)``, 20 rounds in 5 groups of 4 with a key injection after each
group.  Additions wrap modulo 2^32 as int32 arithmetic does; a logical
right shift masks away the sign bits.  ``rounds`` other than 20 exists for
the control, which breaks the stated stream.
"""

from __future__ import annotations

import torch

ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def i32(v: int) -> int:
    """The int32 whose bit pattern is ``v`` mod 2^32."""
    v = int(v) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry2x32(k0: int, k1: int, c0: torch.Tensor, c1: int, rounds: int = 20) -> torch.Tensor:
    """Word 0 of Threefry-2x32 of counter ``(c0, c1)`` under key ``(k0, k1)``
    (Python ints taken mod 2^32; ``c0`` an int32 tensor).  ``rounds`` is a
    multiple of 4."""
    if rounds % 4:
        raise ValueError(f"rounds must be a multiple of 4, got {rounds}")
    keys = (i32(k0), i32(k1), i32(k0 ^ k1 ^ PARITY))
    x0 = c0 + keys[0]
    x1 = torch.full_like(c0, i32(c1 + keys[1]))
    for group in range(rounds // 4):
        for r in ROTATIONS[group % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + keys[(group + 1) % 3]
        x1 = x1 + i32(keys[(group + 2) % 3] + group + 1)
    return x0


def below(u: torch.Tensor, threshold: int) -> torch.Tensor:
    """Unsigned ``u < threshold`` of int32 bit patterns: flipping the sign
    bit maps unsigned order onto signed."""
    return (u ^ i32(1 << 31)) < i32(threshold ^ (1 << 31))
