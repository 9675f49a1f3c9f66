"""Size rounding (from ``tpu_life/utils/padding.py``; the TPU lane and
sublane constants stay behind — the GPU kernels pick their own tiles)."""

from __future__ import annotations


def ceil_div(x: int, m: int) -> int:
    return -(-x // m)
