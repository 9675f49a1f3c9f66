"""ctypes binding to the port's native codec (``csrc/codec.cpp``).

The JAX package's ``io/native.py`` over the port's own copy of the source,
built at first use by :mod:`tpu_life_torch.utils.nativelib`.  The entry
points, the error messages and the thread count (``min(16, cpu_count)``)
are the JAX binding's.  Unlike it, a library that does not build raises
:class:`~tpu_life_torch.utils.nativelib.NativeBuildError` rather than
falling back to numpy; ``TPU_LIFE_NATIVE=0`` is the way onto the numpy
codec.  Input buffers are passed by pointer, so a ``bytearray`` or a
``memoryview`` is not copied.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from tpu_life_torch.kernels._build import CSRC
from tpu_life_torch.utils import nativelib
from tpu_life_torch.utils.nativelib import default_threads as _default_threads

SOURCE = CSRC / "codec.cpp"

_INT_FUNCTIONS = (
    "tl_decode",
    "tl_encode",
    "tl_read_stripe",
    "tl_write_stripe",
    "tl_read_block",
    "tl_write_block",
)

_ERRORS = {
    -1: "I/O error",
    -2: "bad geometry or byte length",
    -3: "byte outside '0'..'9'",
}


def _lib() -> ctypes.CDLL:
    return nativelib.library(SOURCE, _INT_FUNCTIONS)


def build() -> bool:
    """Build and load the library now; raises ``NativeBuildError`` when it
    cannot, and returns False only when ``TPU_LIFE_NATIVE=0``."""
    if nativelib.disabled():
        return False
    _lib()
    return True


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise ValueError(f"native {what} failed: {_ERRORS.get(rc, rc)}")


def _cells(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def decode_board(buf, height: int, width: int) -> np.ndarray:
    src = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty((height, width), dtype=np.int8)
    rc = _lib().tl_decode(
        ctypes.c_void_p(src.ctypes.data),
        ctypes.c_long(src.size),
        ctypes.c_long(height),
        ctypes.c_long(width),
        _cells(out),
        ctypes.c_int(_default_threads()),
    )
    _check(rc, "decode")
    return out


def encode_array(board: np.ndarray) -> np.ndarray:
    """The on-disk bytes of ``board`` in a uint8 array (no copy to bytes)."""
    board = np.ascontiguousarray(board, dtype=np.int8)
    h, w = board.shape
    out = np.empty(h * (w + 1), dtype=np.uint8)
    rc = _lib().tl_encode(
        _cells(board),
        ctypes.c_long(h),
        ctypes.c_long(w),
        ctypes.c_void_p(out.ctypes.data),
        ctypes.c_int(_default_threads()),
    )
    _check(rc, "encode")
    return out


def read_stripe(path, row_start: int, num_rows: int, width: int) -> np.ndarray:
    out = np.empty((num_rows, width), dtype=np.int8)
    rc = _lib().tl_read_stripe(
        os.fspath(path).encode(),
        ctypes.c_long(row_start),
        ctypes.c_long(num_rows),
        ctypes.c_long(width),
        _cells(out),
        ctypes.c_int(_default_threads()),
    )
    _check(rc, "read_stripe")
    return out


def read_block(
    path,
    row_start: int,
    num_rows: int,
    col_start: int,
    num_cols: int,
    width: int,
) -> np.ndarray:
    """Threaded strided-segment block read (``tl_read_block``)."""
    out = np.empty((num_rows, num_cols), dtype=np.int8)
    rc = _lib().tl_read_block(
        os.fspath(path).encode(),
        ctypes.c_long(row_start),
        ctypes.c_long(num_rows),
        ctypes.c_long(col_start),
        ctypes.c_long(num_cols),
        ctypes.c_long(width),
        _cells(out),
        ctypes.c_int(_default_threads()),
    )
    _check(rc, "read_block")
    return out


def write_block(
    path,
    row_start: int,
    col_start: int,
    block: np.ndarray,
    *,
    total_rows: int,
    total_cols: int,
) -> None:
    """Threaded strided-segment block write (``tl_write_block``)."""
    block = np.ascontiguousarray(block, dtype=np.int8)
    h, w = block.shape
    rc = _lib().tl_write_block(
        os.fspath(path).encode(),
        ctypes.c_long(row_start),
        ctypes.c_long(col_start),
        ctypes.c_long(h),
        ctypes.c_long(w),
        ctypes.c_long(total_rows),
        ctypes.c_long(total_cols),
        _cells(block),
        ctypes.c_int(_default_threads()),
    )
    _check(rc, "write_block")


def write_stripe(path, row_start: int, stripe: np.ndarray, *, total_rows: int) -> None:
    stripe = np.ascontiguousarray(stripe, dtype=np.int8)
    h, w = stripe.shape
    rc = _lib().tl_write_stripe(
        os.fspath(path).encode(),
        ctypes.c_long(row_start),
        ctypes.c_long(h),
        ctypes.c_long(w),
        ctypes.c_long(total_rows),
        _cells(stripe),
        ctypes.c_int(_default_threads()),
    )
    _check(rc, "write_stripe")
