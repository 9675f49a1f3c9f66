"""Byte-exact board / config codec — the I/O contract.

A copy of ``tpu_life/io/codec.py``, so files move between the two packages
unchanged:

- Board file (``data.txt`` / ``output.txt``): ``h`` rows of ``w`` ASCII digit
  cells followed by ``'\\n'``; row stride is ``w + 1`` bytes; Unix EOL only.
  A continuous-tier board is ``4 * h * w`` bytes of little-endian float32
  instead; the two lengths never coincide.
- Config file (``grid_size_data.txt``): three whitespace-separated integers
  ``height width epochs``.

Cells are ASCII ``'0'..'9'`` on disk and ``int8`` states 0..9 in memory.

Digit boards of at least ``_NATIVE_THRESHOLD`` cells go through the
threaded C++ codec (``io/native.py`` over ``csrc/codec.cpp``, built at
first use) under the JAX function's conditions; smaller boards, float
boards and ``TPU_LIFE_NATIVE=0`` take the numpy path.  Both paths give the
same bytes; a malformed buffer raises ``ValueError`` on either side of the
threshold, with the JAX package's message on that side.
"""

from __future__ import annotations

import os

import numpy as np

ASCII_ZERO = 48  # ord('0'); disk cell byte = state + ASCII_ZERO
NEWLINE = 10  # ord('\n')


def row_stride(width: int) -> int:
    """Bytes per board row on disk: ``width`` cells + one newline."""
    return width + 1


_NATIVE_THRESHOLD = 1 << 20  # cells; below this numpy wins on call overhead


def _native():
    """The native codec module, or None when ``TPU_LIFE_NATIVE=0``.  A
    library that does not build raises at its first call."""
    from tpu_life_torch.io import native
    from tpu_life_torch.utils import nativelib

    return None if nativelib.disabled() else native


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
    if height * width >= _NATIVE_THRESHOLD:
        nat = _native()
        if nat is not None and len(buf) == height * row_stride(width):
            return nat.decode_board(buf, height, width)
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
    return _encoded(board).tobytes()


def _encoded(board: np.ndarray) -> np.ndarray:
    """The on-disk bytes of ``board`` as a C-contiguous array, which
    :func:`write_board` writes without copying it to ``bytes``."""
    board = np.asarray(board)
    if board.ndim != 2:
        raise ValueError(f"board must be 2-D, got shape {board.shape}")
    if np.issubdtype(board.dtype, np.floating):
        return np.ascontiguousarray(board, dtype="<f4")
    h, w = board.shape
    if h * w >= _NATIVE_THRESHOLD:
        nat = _native()
        if nat is not None:
            return nat.encode_array(board)
    out = np.empty((h, w + 1), dtype=np.uint8)
    out[:, :w] = board.astype(np.uint8) + ASCII_ZERO
    out[:, w] = NEWLINE
    return out


def read_board(path: str | os.PathLike, height: int, width: int) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_board(f.read(), height, width)


def write_board(path: str | os.PathLike, board: np.ndarray) -> None:
    buf = _encoded(board)
    with open(path, "wb") as f:
        f.write(memoryview(buf).cast("B"))


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
