"""Kernel K2: k masked steps of an int8 board per pass, hand-written CUDA.

Replaces the TPU kernel ``make_pallas_multi_step`` with its bodies
``_vmem_counts`` and ``_int8_substeps`` and the frame re-zeroing
``_zero_frame`` (``tpu_life/backends/pallas_backend.py``).  The source is
``tpu_life_torch/csrc/int8_tiled.cu``; it is compiled by ``nvcc`` for
``sm_90a`` at first use (``kernels._build``) and called through ``ctypes``.

The function both versions compute: ``steps`` steps of an unframed,
contiguous ``int8[H, W]`` board, each equal to
``stencil.make_masked_step(rule, (H, W))`` on the whole board, for any
clamped Moore rule (radius r >= 1, the centre counted or not, 2 to 10
states: life-like, Generations, Larger-than-Life).

- :func:`int8_multi_step` launches the kernel for a CUDA tensor:
  ``steps // block_steps`` launches of ``block_steps`` substeps each, then
  one launch for the remainder.  For a CPU tensor it runs the plain
  version.  Any other device raises; nothing falls back.
- :func:`int8_multi_step_plain` is the plain PyTorch version, on any
  device: the CPU tests use it, and ``chip_smoke.py`` holds the kernel to
  it on the card.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from tpu_life_torch.kernels import _build
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops import stencil
from tpu_life_torch.utils.padding import ceil_div

SOURCE = _build.CSRC / "int8_tiled.cu"
MAX_BLOCK_STEPS = 32
# the base output tile; the backend clamps the block depth to it, as the
# TPU backend does (PallasBackend.prepare: min(block_rows, block_cols) // 4r)
TILE_ROWS = 32
TILE_COLS = 128
MAX_SHARED_BYTES = 232_448  # dynamic shared memory one Hopper block may opt into
MAX_GRID_ROWS = 65_535  # gridDim.y: row tiles per launch


def supports(rule: Rule) -> bool:
    """Clamped Moore rules: the family K2 computes."""
    return rule.neighborhood == "moore" and rule.boundary == "clamped"


def clamp_block_steps(rule: Rule, block_steps: int) -> int:
    """The block depth the backend runs: at most ``block_steps``, and deep
    enough only while the halo (r*k on each side) stays a minor share of
    the base tile; at least 1, so every radius runs."""
    return max(1, min(block_steps, min(TILE_ROWS, TILE_COLS) // (4 * rule.radius)))


def _ceil_to(x: int, m: int) -> int:
    return ceil_div(x, m) * m


def window(rule: Rule, block_steps: int, cols: int) -> tuple[int, int, int]:
    """The shared-memory window of a tile ``cols`` wide, as the kernel lays
    it out: its columns (the tile, the halo on both sides and up to 3
    columns from rounding its first column down to a multiple of 4), the
    row pitch of its int8 buffers and that of its int16 vertical sums in
    bytes, each an odd number of 32-bit words so that consecutive rows
    start in different banks."""
    ext_c = _ceil_to(cols + 2 * rule.radius * block_steps + 3, 4)
    return ext_c, 4 * (ext_c // 4 | 1), 2 * (ext_c // 2 | 1)


def shared_bytes(rule: Rule, block_steps: int, rows: int, cols: int) -> int:
    """Dynamic shared memory of one block: two int8 window buffers and the
    int16 vertical sums (:func:`window`), and the rule's transition
    table."""
    _, p8, pv = window(rule, block_steps, cols)
    ext_r = rows + 2 * rule.radius * block_steps
    return 2 * ext_r * p8 + 2 * ext_r * pv + rule.states * (rule.max_count + 1)


def tile_shape(
    rule: Rule, block_steps: int, height: int, width: int, n_sm: int
) -> tuple[int, int]:
    """Output rows and columns of one block; the columns are always a
    multiple of 16, as 16-byte stores need.  The base tile grows to four
    halos where the halo is deep (large radius); on a board too small to
    give every SM a block its height halves, down to 8 rows; where the
    window would not fit in shared memory the tile shrinks, down to 8 x 16.
    Raises ``ValueError`` where even that does not fit (a radius far beyond
    the Larger-than-Life rules in use)."""
    halo = rule.radius * block_steps
    rows = max(TILE_ROWS, _ceil_to(4 * halo, 8))
    cols = max(TILE_COLS, _ceil_to(4 * halo, 16))
    while rows > 8 and ceil_div(width, cols) * ceil_div(height, rows) < n_sm:
        rows = max(8, rows // 2)
    while shared_bytes(rule, block_steps, rows, cols) > MAX_SHARED_BYTES and (
        rows > 8 or cols > 16
    ):
        if rows >= cols or cols == 16:
            rows = max(8, rows // 2)
        else:
            cols = max(16, _ceil_to(cols // 2, 16))
    need = shared_bytes(rule, block_steps, rows, cols)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"rule {rule.name!r} (radius {rule.radius}, {rule.states} states) at "
            f"block_steps={block_steps} needs {need} bytes of shared memory for "
            f"the smallest tile of the int8 kernel, over the {MAX_SHARED_BYTES} "
            f"a Hopper block may use"
        )
    return rows, cols


def io16(width: int, cols: int, *ptrs: int) -> bool:
    """Whether a launch may load and store 16 bytes at a time: every row
    and every tile then starts on a 16-byte boundary of aligned buffers,
    so each 16-byte chunk lies wholly inside or wholly outside the board
    and the tile."""
    return width % 16 == 0 and cols % 16 == 0 and all(p % 16 == 0 for p in ptrs)


def int_ops_per_cell_step(rule: Rule) -> int:
    """The 32-bit integer operations one cell needs per step, counting one
    for a three-input ``IADD3`` (a + b - c) and one for ``IMAD``: the alive
    test (state == 1), the vertical and the horizontal running windows (one
    each: add the entering value, subtract the leaving one), the centre
    (none when the rule counts it), the table read (the index
    state * (max_count + 1) + count, and the load) and the board mask (one
    select)."""
    return 1 + 2 + (0 if rule.include_center else 1) + 2 + 1


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.library(SOURCE)
    lib.int8_tiled_multi_step.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    )
    lib.sharded_int8_block.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 20 + [ctypes.c_void_p]
    for fn in (lib.int8_tiled_multi_step, lib.sharded_int8_block):
        fn.restype = ctypes.c_int
    return lib


def build() -> Path:
    """Compile the kernel library (K2 and K4, ``_build.build``) and return
    its path; ``build.log`` beside it keeps nvcc's ``-Xptxas -v`` report."""
    return _build.build(SOURCE)


@functools.cache
def _table(rule: Rule, device: torch.device) -> torch.Tensor:
    """The rule's transition table, int8[states, max_count + 1], on the
    device: the kernel's rule, as data.  Kept per (rule, device): a copy
    from host memory at every call would wait for the launches already
    queued on the stream."""
    return torch.from_numpy(np.ascontiguousarray(rule.transition_table)).to(device)


def _check(x: torch.Tensor, logical_shape: tuple[int, int], name: str) -> None:
    if x.dtype != torch.int8:
        raise TypeError(f"{name} must be an int8 board, got {x.dtype}")
    if tuple(x.shape) != tuple(logical_shape):
        raise ValueError(
            f"{name} has shape {tuple(x.shape)}, want the unframed board "
            f"{tuple(logical_shape)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def int8_multi_step_plain(
    x: torch.Tensor, rule: Rule, logical_shape: tuple[int, int], steps: int
) -> torch.Tensor:
    """The plain PyTorch version: ``stencil.multi_step`` on ``x``'s device."""
    return stencil.multi_step(x, rule=rule, steps=steps, logical_shape=tuple(logical_shape))


def int8_multi_step(
    x: torch.Tensor,
    rule: Rule,
    logical_shape: tuple[int, int],
    steps: int,
    *,
    block_steps: int,
    scratch: torch.Tensor | None = None,
) -> torch.Tensor:
    """``steps`` masked steps of the int8 board ``x``.

    On a CUDA tensor each launch reads one buffer and writes the other,
    ping-ponging between ``x`` and ``scratch`` (allocated when None), and
    the function returns whichever holds the result: afterwards the
    contents of ``x`` and ``scratch`` are unspecified.  On a CPU tensor it
    returns the plain version's result.
    """
    if not supports(rule):
        raise ValueError(f"the int8 tiled kernel runs clamped Moore rules only, got {rule}")
    if not 1 <= block_steps <= MAX_BLOCK_STEPS:
        raise ValueError(f"block_steps must be in [1, {MAX_BLOCK_STEPS}], got {block_steps}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    _check(x, logical_shape, "x")
    if x.device.type == "cpu":
        return int8_multi_step_plain(x, rule, logical_shape, steps)
    if x.device.type != "cuda":
        raise ValueError(f"int8_multi_step runs on cuda or cpu tensors, got {x.device}")
    if scratch is None:
        scratch = torch.empty_like(x)
    _check(scratch, logical_shape, "scratch")
    if scratch.device != x.device or scratch.data_ptr() == x.data_ptr():
        raise ValueError("scratch must be a second buffer on x's device")
    lh, lw = logical_shape
    blocks, rem = divmod(steps, block_steps)
    ks = [block_steps] * blocks + ([rem] if rem else [])
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    tiles = {k: tile_shape(rule, k, lh, lw, n_sm) for k in set(ks)}
    for rows, _ in tiles.values():
        if ceil_div(lh, rows) > MAX_GRID_ROWS:
            raise ValueError(f"a board of {lh} rows needs more than {MAX_GRID_ROWS} row tiles")
    fn = _library().int8_tiled_multi_step
    table = _table(rule, x.device)
    src, dst = x, scratch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for k in ks:
            rows, cols = tiles[k]
            err = fn(
                src.data_ptr(), dst.data_ptr(), table.data_ptr(), lh, lw,
                rule.radius, k, int(rule.include_center), rule.states, table.shape[1],
                rows, cols, *window(rule, k, cols), shared_bytes(rule, k, rows, cols),
                int(io16(lw, cols, x.data_ptr(), scratch.data_ptr())), stream,
            )
            if err != 0:
                raise RuntimeError(f"int8_tiled_multi_step launch failed: CUDA error {err}")
            int8_multi_step.launches += 1
            src, dst = dst, src
    return src


int8_multi_step.launches = 0
