"""Byte-exact board / config codec — the I/O contract, numpy path only.

A copy of ``tpu_life/io/codec.py`` without the native C++ codec, so files
move between the two packages unchanged:

- Board file (``data.txt`` / ``output.txt``): ``h`` rows of ``w`` ASCII digit
  cells followed by ``'\\n'``; row stride is ``w + 1`` bytes; Unix EOL only.
  A continuous-tier board is ``4 * h * w`` bytes of little-endian float32
  instead; the two lengths never coincide.
- Config file (``grid_size_data.txt``): three whitespace-separated integers
  ``height width epochs``.

Cells are ASCII ``'0'..'9'`` on disk and ``int8`` states 0..9 in memory.
"""

from __future__ import annotations

import os

import numpy as np

ASCII_ZERO = 48  # ord('0'); disk cell byte = state + ASCII_ZERO
NEWLINE = 10  # ord('\n')


def row_stride(width: int) -> int:
    """Bytes per board row on disk: ``width`` cells + one newline."""
    return width + 1


def float_board_bytes(height: int, width: int) -> int:
    """On-disk byte length of a float32 (continuous-tier) board."""
    return height * width * 4


def decode_board(buf: bytes | bytearray | memoryview, height: int, width: int) -> np.ndarray:
    """Parse board bytes into an ``int8`` array of shape ``(height, width)``,
    validating the newline grid structure and the cell alphabet — or a
    ``float32`` array for a continuous-tier board, told apart by its length
    (``w + 1 == 4w`` has no positive integer solution)."""
    if len(buf) == float_board_bytes(height, width) and len(buf) != height * row_stride(width):
        a = np.frombuffer(buf, dtype="<f4").reshape(height, width)
        if not np.isfinite(a).all():
            raise ValueError("float board contains NaN or Inf")
        return a.astype(np.float32)
    stride = row_stride(width)
    expected = height * stride
    if len(buf) != expected:
        raise ValueError(
            f"board byte length {len(buf)} != expected {expected} "
            f"({height} rows x {stride} bytes)"
        )
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(height, stride)
    if not (raw[:, width] == NEWLINE).all():
        bad = int(np.argmin(raw[:, width] == NEWLINE))
        raise ValueError(f"row {bad} is not terminated by '\\n'")
    cells = raw[:, :width]
    if not ((cells >= ASCII_ZERO) & (cells <= ASCII_ZERO + 9)).all():
        raise ValueError("board contains bytes outside '0'..'9'")
    return (cells - ASCII_ZERO).astype(np.int8)


def encode_board(board: np.ndarray) -> bytes:
    """Serialize an ``int8`` state array to the on-disk byte format, or a
    ``float32`` (continuous-tier) board to its raw little-endian bytes."""
    board = np.asarray(board)
    if board.ndim != 2:
        raise ValueError(f"board must be 2-D, got shape {board.shape}")
    if np.issubdtype(board.dtype, np.floating):
        return np.ascontiguousarray(board, dtype="<f4").tobytes()
    h, w = board.shape
    out = np.empty((h, w + 1), dtype=np.uint8)
    out[:, :w] = board.astype(np.uint8) + ASCII_ZERO
    out[:, w] = NEWLINE
    return out.tobytes()


def read_board(path: str | os.PathLike, height: int, width: int) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_board(f.read(), height, width)


def write_board(path: str | os.PathLike, board: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_board(board))


def read_config(path: str | os.PathLike) -> tuple[int, int, int]:
    """Read ``height width epochs`` from a config file (any whitespace, no
    trailing newline needed)."""
    with open(path, "r") as f:
        parts = f.read().split()
    if len(parts) != 3:
        raise ValueError(f"config {path!r}: expected 3 integers, got {parts!r}")
    h, w, epochs = (int(p) for p in parts)
    if h <= 0 or w <= 0 or epochs < 0:
        raise ValueError(f"config {path!r}: invalid values h={h} w={w} epochs={epochs}")
    return h, w, epochs


def write_config(path: str | os.PathLike, height: int, width: int, epochs: int) -> None:
    with open(path, "w") as f:
        f.write(f"{height} {width} {epochs}")
