"""Per-shard board file I/O: the analogue of MPI-IO (a trimmed copy of
``tpu_life/io/sharded.py``).

The reference reads and writes each rank's stripe at a computed byte
offset with ``MPI_File_read_at`` / ``MPI_File_write_at_all``
(Parallel_Life_MPI.cpp:85, :175).  Here each shard touches only the byte
ranges of its own block, so a streamed run never holds the whole board on
one host.

Offsets are the reference's: row ``r`` lives at byte ``r * (w + 1)`` and a
block's row segment starting at cell ``c`` at ``r * (w + 1) + c``.  A
written file is pre-sized with ``O_CREAT`` and no truncation, so writers
of different blocks may write in any order, and the shard that owns the
last column writes each row's ``'\\n'``.  Blocks are halo-free: halos come
from the exchange between shards, never from the file.

Blocks of at least ``codec._NATIVE_THRESHOLD`` cells go through the
threaded C++ codec (``codec._native()``: ``tl_read_stripe``,
``tl_read_block``, ``tl_write_block``, ``tl_write_stripe``) as the JAX
module's do; smaller ones, and every block under ``TPU_LIFE_NATIVE=0``,
take the ``pread``/``pwrite`` path, with the same bytes.  Only the digit
codec is streamed: a continuous rule's float32 board has no per-row
layout here.
"""

from __future__ import annotations

import os

import numpy as np

from tpu_life_torch.io.codec import (
    ASCII_ZERO,
    NEWLINE,
    decode_board,
    encode_board,
    row_stride,
)


def stripe_bounds(height: int, num_shards: int) -> list[tuple[int, int]]:
    """Row ranges ``[(start, stop), ...]`` for a 1-D stripe decomposition.

    Uses balanced splitting: the first ``height % num_shards`` stripes get one
    extra row.  (The reference instead gives the whole remainder to the last
    rank, Parallel_Life_MPI.cpp:76-78 — balanced splitting has strictly better
    load balance and matches ``jax.sharding`` row partitioning when ``height``
    is not divisible by the mesh size... it is also what XLA's GSPMD requires
    us to pad toward, so the even-split fast path stays aligned.)
    """
    if num_shards <= 0:
        raise ValueError(f"num_shards must be positive, got {num_shards}")
    base, rem = divmod(height, num_shards)
    bounds = []
    start = 0
    for i in range(num_shards):
        n = base + (1 if i < rem else 0)
        bounds.append((start, start + n))
        start += n
    return bounds


def read_stripe(
    path: str | os.PathLike, row_start: int, num_rows: int, width: int
) -> np.ndarray:
    """Read rows ``[row_start, row_start + num_rows)`` of a board file."""
    from tpu_life_torch.io import codec

    nat = codec._native()
    if nat is not None and num_rows * width >= codec._NATIVE_THRESHOLD:
        return nat.read_stripe(path, row_start, num_rows, width)
    stride = row_stride(width)
    with open(path, "rb") as f:
        f.seek(row_start * stride)
        buf = f.read(num_rows * stride)
    return decode_board(buf, num_rows, width)


def read_block(
    path: str | os.PathLike,
    row_start: int,
    num_rows: int,
    col_start: int,
    num_cols: int,
    width: int,
) -> np.ndarray:
    """Read the rectangular sub-block rows ``[row_start, row_start+num_rows)``
    × cells ``[col_start, col_start+num_cols)`` of a board file.

    The 2-D-mesh analogue of the reference's per-rank offset reads
    (Parallel_Life_MPI.cpp:85), generalized to blocks: one ``pread`` per row
    of exactly the segment's bytes, so a column shard never touches (or
    re-reads) the rest of the row.  Full-width requests delegate to
    :func:`read_stripe` (native fast path).
    """
    if col_start == 0 and num_cols == width:
        return read_stripe(path, row_start, num_rows, width)
    if col_start < 0 or col_start + num_cols > width:
        raise ValueError(
            f"column range [{col_start}, {col_start + num_cols}) outside "
            f"board width {width}"
        )
    from tpu_life_torch.io import codec

    nat = codec._native()
    if nat is not None and num_rows * num_cols >= codec._NATIVE_THRESHOLD:
        # threaded C path: the per-row-segment pread fan-out runs as
        # parallel C instead of a Python syscall loop
        return nat.read_block(path, row_start, num_rows, col_start, num_cols, width)
    stride = row_stride(width)
    out = np.empty((num_rows, num_cols), dtype=np.uint8)
    fd = os.open(os.fspath(path), os.O_RDONLY)
    try:
        for i in range(num_rows):
            off = (row_start + i) * stride + col_start
            buf = os.pread(fd, num_cols, off)
            if len(buf) != num_cols:
                raise ValueError(
                    f"short read at row {row_start + i}: got {len(buf)} of "
                    f"{num_cols} bytes"
                )
            out[i] = np.frombuffer(buf, dtype=np.uint8)
    finally:
        os.close(fd)
    if not ((out >= ASCII_ZERO) & (out <= ASCII_ZERO + 9)).all():
        raise ValueError("board block contains bytes outside '0'..'9'")
    return (out - ASCII_ZERO).astype(np.int8)


def write_block(
    path: str | os.PathLike,
    row_start: int,
    col_start: int,
    block: np.ndarray,
    *,
    total_rows: int,
    total_cols: int,
) -> None:
    """Write a rectangular sub-block at its contract byte offsets.

    Generalizes :func:`write_stripe` to 2-D block decompositions: row ``r``'s
    segment lands at byte ``r * (total_cols + 1) + col_start`` — the
    ``MPI_File_write_at_all`` offset scheme (Parallel_Life_MPI.cpp:172-175)
    extended with a column offset.  The shard owning the last column also
    writes each row's ``'\\n'`` terminator (a pre-sized file is
    zero-filled, so some writer must own every byte of the stride).
    """
    block = np.asarray(block)
    h, w = block.shape
    if row_start < 0 or row_start + h > total_rows:
        # before ANY path (including the full-width write_stripe delegation):
        # a silent pwrite past the pre-sized file would corrupt the contract,
        # and the native rc=-2 check must not be stricter than Python's
        raise ValueError(
            f"row range [{row_start}, {row_start + h}) outside board "
            f"height {total_rows}"
        )
    if col_start == 0 and w == total_cols:
        write_stripe(path, row_start, block, total_rows=total_rows)
        return
    if col_start < 0 or col_start + w > total_cols:
        raise ValueError(
            f"column range [{col_start}, {col_start + w}) outside board "
            f"width {total_cols}"
        )
    from tpu_life_torch.io import codec

    nat = codec._native()
    if nat is not None and h * w >= codec._NATIVE_THRESHOLD:
        nat.write_block(
            path, row_start, col_start, block, total_rows=total_rows, total_cols=total_cols
        )
        return
    stride = row_stride(total_cols)
    last_col = col_start + w == total_cols
    seg = np.empty((h, w + (1 if last_col else 0)), dtype=np.uint8)
    seg[:, :w] = block.astype(np.uint8) + ASCII_ZERO
    if last_col:
        seg[:, w] = NEWLINE
    payload = seg.tobytes()
    k = seg.shape[1]
    fd = os.open(os.fspath(path), os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        total = total_rows * stride
        if os.fstat(fd).st_size != total:
            os.ftruncate(fd, total)
        for i in range(h):
            os.pwrite(
                fd,
                payload[i * k : (i + 1) * k],
                (row_start + i) * stride + col_start,
            )
    finally:
        os.close(fd)


def write_stripe(
    path: str | os.PathLike, row_start: int, stripe: np.ndarray, *, total_rows: int
) -> None:
    """Write a stripe at its byte offset into a (possibly sparse) board file.

    The file is pre-sized to the full board so independent writers can write
    their stripes in any order — the collective-write analogue of
    ``MPI_File_write_at_all`` (Parallel_Life_MPI.cpp:175).
    """
    from tpu_life_torch.io import codec

    stripe = np.asarray(stripe)
    h, w = stripe.shape
    if row_start < 0 or row_start + h > total_rows:
        raise ValueError(
            f"row range [{row_start}, {row_start + h}) outside board "
            f"height {total_rows}"
        )
    nat = codec._native()
    if nat is not None and h * w >= codec._NATIVE_THRESHOLD:
        nat.write_stripe(path, row_start, stripe, total_rows=total_rows)
        return
    stride = row_stride(w)
    total = total_rows * stride
    # O_CREAT without truncation so concurrent stripe writers don't clobber
    # each other's bytes.
    fd = os.open(os.fspath(path), os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        if os.fstat(fd).st_size != total:
            os.ftruncate(fd, total)
        os.pwrite(fd, encode_board(stripe), row_start * stride)
    finally:
        os.close(fd)
