"""Kernel K4: one block of k masked int8 steps on one shard, hand-written CUDA.

Replaces the TPU kernel ``make_pallas_sharded_int8_block``
(``tpu_life/backends/pallas_backend.py``), with the functions that run
it, ``make_sharded_pallas_int8_run`` and the ``fc > 0`` branch of
``_sharded_epoch_loop``: the per-shard stepper of the sharded backend for
the clamped Moore rules that do not run packed (Generations,
Larger-than-Life, ``bitpack=False``), on 1-D and 2-D meshes.  It is K2 per
shard and lives in K2's source, ``tpu_life_torch/csrc/int8_tiled.cu``
(``sharded_int8_kernel``), sharing K2's substeps, layout and rule bits
(``int8_tiled.launch_args``); it is built with K2 by ``nvcc`` for
``sm_90a`` at first use and called through ``ctypes``.  It loads its
window with asynchronous copies from the five pieces where they lie: 16
bytes at a time from the rows of ``top``, the chunk and ``bot`` where the
chunk's width and the buffers allow, and what ``r * block_steps`` allows
from ``left`` and ``right`` (:func:`copy_sizes`).

The function both versions compute: ``block(top, chunk, bot, row0, left,
right, col0) -> chunk'``, ``block_steps`` masked steps of one shard's
``int8[hl, wl]`` chunk, whose halos hold the board's cells around it (zeros
past the board): ``top`` and ``bot`` the ``r * block_steps`` rows above and
below it, and on a mesh of columns ``left`` and ``right`` the ``r *
block_steps`` columns beside the rows of ``top``, the chunk and ``bot``
(corners included).  ``(row0, col0)`` is the board coordinate of
``top[0]``'s row and of ``left``'s column 0 (without column halos, of the
chunk's column 0).  Cells outside the board, the padding rows and columns
of the last shards among them, are pinned dead after every step.

- :func:`sharded_int8_block` launches the kernel for CUDA tensors, and
  runs the plain version for CPU tensors.  Any other device raises;
  nothing falls back; on the card a radius past ``int8_tiled.MAX_RADIUS``
  (127) or a window past shared memory raises ``ValueError``
  (``int8_tiled.tile_shape``).
- :func:`sharded_int8_block_plain` is the plain version: the sharded
  backend's per-shard int8 block in plain ops
  (``parallel.halo.make_shard_block(packed=False)``).
"""

from __future__ import annotations

import math

import torch

from tpu_life_torch.kernels import int8_tiled
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.parallel import halo


def sharded_int8_block_plain(
    top: torch.Tensor,
    chunk: torch.Tensor,
    bot: torch.Tensor,
    row0: int,
    rule: Rule,
    logical_shape: tuple[int, int],
    block_steps: int,
    *,
    left: torch.Tensor | None = None,
    right: torch.Tensor | None = None,
    col0: int = 0,
) -> torch.Tensor:
    """The plain PyTorch version, on any device: stack the chunk and its
    halos, ``block_steps`` masked int8 steps, keep the chunk's cells."""
    block = halo.make_shard_block(
        rule, tuple(logical_shape), block_steps, packed=False, split_cols=left is not None
    )
    return block(top, chunk, bot, row0, left, right, col0)


def copy_sizes(cols: int, fc: int, mid_ptrs: list[int], side_ptrs: list[int]) -> tuple[int, int]:
    """The bytes of one copy of K4's window (``int8_tiled.io_bytes``): of
    the rows of ``top``, the chunk and ``bot`` (and of the stores to
    ``out``), which divide ``cols`` and their addresses; and of the rows of
    ``left`` and ``right`` and the zeros beside them, which divide ``fc``
    and ``cols`` and the addresses of ``left``, ``right`` and the chunk (the
    address a zero copy names).  Without column halos (``fc = 0``) the
    second is the first."""
    io = int8_tiled.io_bytes(cols, *mid_ptrs)
    return io, int8_tiled.io_bytes(math.gcd(fc, cols), *side_ptrs) if fc else io


def _check(x: torch.Tensor, shape: tuple[int, int], name: str) -> None:
    if x.dtype != torch.int8:
        raise TypeError(f"{name} must be int8 cells, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, want {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sharded_int8_block(
    top: torch.Tensor,
    chunk: torch.Tensor,
    bot: torch.Tensor,
    row0: int,
    rule: Rule,
    logical_shape: tuple[int, int],
    block_steps: int,
    *,
    left: torch.Tensor | None = None,
    right: torch.Tensor | None = None,
    col0: int = 0,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``block_steps`` steps of one shard (see the module docstring).

    On CUDA tensors the kernel writes ``out`` (allocated when None; a
    buffer other than the inputs) on the current stream of the chunk's
    device, with that device current, and returns it.  On CPU tensors it
    returns the plain version's new tensor.
    """
    if not int8_tiled.supports(rule):
        raise ValueError(f"the sharded int8 kernel runs clamped Moore rules only, got {rule}")
    if not 1 <= block_steps <= int8_tiled.MAX_BLOCK_STEPS:
        raise ValueError(
            f"block_steps must be in [1, {int8_tiled.MAX_BLOCK_STEPS}], got {block_steps}"
        )
    if chunk.dim() != 2:
        raise ValueError(f"chunk must be a 2-D board, got shape {tuple(chunk.shape)}")
    if (left is None) != (right is None):
        raise ValueError("give both column halos (a mesh of columns) or neither")
    hl, wl = chunk.shape
    fr = halo.halo_depth(rule, block_steps)
    fc = fr if left is not None else 0
    _check(chunk, (hl, wl), "chunk")
    _check(top, (fr, wl), "top")
    _check(bot, (fr, wl), "bot")
    pieces = [top, chunk, bot]
    if fc:
        _check(left, (hl + 2 * fr, fc), "left")
        _check(right, (hl + 2 * fr, fc), "right")
        pieces += [left, right]
    devices = {p.device for p in pieces}
    if len(devices) != 1:
        raise ValueError(f"the chunk and its halos must share a device, got {sorted(map(str, devices))}")
    if chunk.device.type == "cpu":
        return sharded_int8_block_plain(
            top, chunk, bot, row0, rule, logical_shape, block_steps,
            left=left, right=right, col0=col0,
        )
    if chunk.device.type != "cuda":
        raise ValueError(f"sharded_int8_block runs on cuda or cpu tensors, got {chunk.device}")
    if out is None:
        out = torch.empty_like(chunk)
    _check(out, (hl, wl), "out")
    if out.device != chunk.device or out.data_ptr() in {p.data_ptr() for p in pieces}:
        raise ValueError("out must be a buffer of its own on the chunk's device")
    n_sm = torch.cuda.get_device_properties(chunk.device).multi_processor_count
    nwords, *rest = int8_tiled.launch_args(rule, block_steps, hl, wl, n_sm)
    lh, lw = logical_shape
    bits = int8_tiled._bits(rule, chunk.device)
    io, io_side = copy_sizes(
        wl, fc, [p.data_ptr() for p in (top, chunk, bot, out)],
        [p.data_ptr() for p in (left, right, chunk)] if fc else [],
    )
    lib = int8_tiled._library()
    with torch.cuda.device(chunk.device):
        stream = torch.cuda.current_stream(chunk.device).cuda_stream
        err = lib.sharded_int8_block(
            top.data_ptr(), chunk.data_ptr(), bot.data_ptr(),
            left.data_ptr() if fc else None, right.data_ptr() if fc else None,
            out.data_ptr(), bits.data_ptr(), nwords, hl, wl, fr, fc, row0, col0, lh, lw,
            *rest, io, io_side, stream,
        )
    if err != 0:
        raise RuntimeError(f"sharded_int8_block launch failed: CUDA error {err}")
    sharded_int8_block.launches += 1
    return out


sharded_int8_block.launches = 0
