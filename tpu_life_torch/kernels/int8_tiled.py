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
states: life-like, Generations, Larger-than-Life).  The kernel runs radii
up to ``MAX_RADIUS`` (127: it keeps vertical sums of 2r + 1 cells in
bytes) whose tile fits shared memory, and takes the rule as data
(:func:`rule_bits`), so one build serves every rule; for a radius past
that the CUDA path raises ``ValueError`` (:func:`tile_shape`).

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
from tpu_life_torch.kernels import packed_stripe as ps
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops import stencil
from tpu_life_torch.utils.padding import ceil_div

SOURCE = _build.CSRC / "int8_tiled.cu"
MAX_BLOCK_STEPS = 32
# the block depth's base: the backend clamps the depth so that the halo
# stays a minor share of a 32 x 128 tile, as the TPU backend does
# (PallasBackend.prepare: min(block_rows, block_cols) // 4r); it is not the
# tile the kernel runs (TILE_ROWS, TILE_COLS)
CLAMP_ROWS = 32
CLAMP_COLS = 128
# the base output tile of a block: at r*k = 8 its substeps compute about
# 1.15x its cells, and three blocks (four at 2 states) fit an SM
TILE_ROWS = 64
TILE_COLS = 256
GUARD = 32  # bytes of shared memory before and after the vertical sums
MAX_RADIUS = 127  # a vertical sum, at most 2r + 1, must fit a byte
MAX_SHARED_BYTES = 232_448  # dynamic shared memory one Hopper block may opt into
MAX_GRID_ROWS = 65_535  # gridDim.y: row tiles per launch


def supports(rule: Rule) -> bool:
    """Clamped Moore rules: the family K2 computes."""
    return rule.neighborhood == "moore" and rule.boundary == "clamped"


def clamp_block_steps(rule: Rule, block_steps: int) -> int:
    """The block depth the backend runs: at most ``block_steps``, and deep
    enough only while the halo (r*k on each side) stays a minor share of
    the clamp's 32 x 128 base; at least 1, so every radius runs."""
    return max(1, min(block_steps, min(CLAMP_ROWS, CLAMP_COLS) // (4 * rule.radius)))


def _ceil_to(x: int, m: int) -> int:
    return ceil_div(x, m) * m


def rule_bits(rule: Rule) -> np.ndarray:
    """The rule as the kernel reads it, ``uint32[nwords]``: bit ``count +
    a * (max_count + 1)`` is set where a cell of state ``a`` (0 or 1) with
    ``count`` live neighbours is alive next; bits ``[0, max_count]`` are
    the birth set, the next ``max_count + 1`` the survive set.  The kernel
    computes the other states: a cell of state 1 whose bit is clear becomes
    2 when the rule has more than 2 states (else 0), a cell of state s >= 2
    becomes ``(s + 1) % states``."""
    birth, survive = rule.tables
    bits = np.concatenate([birth, survive]).astype(bool)
    packed = np.packbits(bits, bitorder="little")
    packed = np.pad(packed, (0, -len(packed) % 4))
    return packed.view("<u4").astype(np.uint32)


def n_words(rule: Rule) -> int:
    """The 32-bit words of :func:`rule_bits`: 2 * (max_count + 1) bits, one
    word at r = 1, where the kernel keeps them in registers; at r >= 2 it
    reads them from shared memory."""
    return ceil_div(2 * (rule.max_count + 1), 32)


def check_radius(rule: Rule) -> None:
    """Raise ``ValueError`` for a radius the kernel cannot run: its
    vertical sums, up to 2r + 1, live in byte lanes."""
    if rule.radius > MAX_RADIUS:
        raise ValueError(
            f"rule {rule.name!r} has radius {rule.radius}; the int8 kernel keeps "
            f"vertical sums of 2r + 1 cells in bytes and runs radii up to {MAX_RADIUS}"
        )


def window(rule: Rule, block_steps: int, cols: int) -> tuple[int, int, int, int]:
    """The shared-memory window of a tile ``cols`` wide, as the kernel lays
    it out: the margin (the halo r*k rounded up to 16 columns, on each
    side), its columns (the tile and both margins), the row pitch of its
    state and alive planes and that of its vertical sums in bytes, each an
    odd number of 16-byte units (so that 16-byte accesses of consecutive
    rows fall in different banks), the sums' at least ``GUARD`` bytes
    past the window."""
    margin = _ceil_to(rule.radius * block_steps, 16)
    ext_c = cols + 2 * margin
    return margin, ext_c, 16 * (ext_c // 16 | 1), 16 * ((ext_c + GUARD) // 16 | 1)


def shared_bytes(rule: Rule, block_steps: int, rows: int, cols: int) -> int:
    """Dynamic shared memory of one block (:func:`window`).  At r >= 2: the
    rule's bits, the state plane, the alive plane (none at 2 states, where
    the states are the alive bits) and the int8 vertical sums with a guard
    of ``GUARD`` bytes before and after.  At r = 1: the state plane (none
    at 2 states) and two planes of alive bits that the substeps alternate,
    with 16-byte guards before, between and after them."""
    _, _, pitch, vpitch = window(rule, block_steps, cols)
    ext_r = rows + 2 * rule.radius * block_steps
    plane = ext_r * pitch
    states = plane if rule.states > 2 else 0
    if rule.radius == 1:
        return states + 2 * plane + 48
    return _ceil_to(4 * n_words(rule), 16) + states + plane + ext_r * vpitch + 2 * GUARD


def tile_shape(
    rule: Rule, block_steps: int, height: int, width: int, n_sm: int
) -> tuple[int, int]:
    """Output rows and columns of one block; the columns are always a
    multiple of 16, as 16-byte copies need.  The base tile grows to four
    halos where the halo is deep (large radius); on a board too small to
    give every SM a block its height halves, down to 8 rows; where the
    window would not fit in shared memory the tile shrinks, down to 8 x 16.
    Raises ``ValueError`` for a radius past ``MAX_RADIUS``, or where even
    that tile does not fit."""
    check_radius(rule)
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


def io_bytes(n: int, *ptrs: int) -> int:
    """The bytes of one copy between device and shared memory: the largest
    of 16, 8 and 4 that divides the row length ``n`` and every address, so
    that each copy lies wholly inside or wholly outside a row; 1 where none
    does."""
    for size in (16, 8, 4):
        if n % size == 0 and all(p % size == 0 for p in ptrs):
            return size
    return 1


def int_ops_per_cell_step(rule: Rule) -> int:
    """The 32-bit integer operations one cell needs per step, counting one
    for a three-input ``IADD3`` (a + b - c) and one for ``IMAD``: the alive
    test (state == 1), the vertical and the horizontal running windows (one
    each: add the entering value, subtract the leaving one), the centre
    (none when the rule counts it), the rule's lookup (the index and the
    read) and the board mask (one select).  This counts the function, not
    what the kernel issues; the bound takes it at r >= 2
    (:func:`ops_per_cell_step`)."""
    return 1 + 2 + (0 if rule.include_center else 1) + 2 + 1


def ops_per_cell_step(rule: Rule) -> float:
    """The 32-bit integer operations the function needs per cell and step,
    for its bound: the fewer of the counts known for it.  At r = 1 a step
    runs bit-sliced, 32 cells a word, as K1 runs life-like rules:
    ``packed_stripe.moore_logic_ops`` of the rule's sets over the 8
    neighbours, and with more than 2 states two more a word (birth gated
    on the dying plane, dying started where a live cell does not survive;
    the dying states' own count is left out, so this stays a lower count),
    over 32 cells.  At r >= 2 :func:`int_ops_per_cell_step`."""
    if rule.radius > 1:
        return int_ops_per_cell_step(rule)
    survive = rule.survive
    if rule.include_center:  # a live cell counts itself
        survive = frozenset(c - 1 for c in survive if c >= 1)
    word = ps.moore_logic_ops(rule.birth, survive) + (2 if rule.states > 2 else 0)
    return word / 32


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.library(SOURCE)
    lib.int8_tiled_multi_step.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    )
    lib.sharded_int8_block.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 23 + [ctypes.c_void_p]
    )
    lib.int8_tiled_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    for fn in (lib.int8_tiled_multi_step, lib.sharded_int8_block, lib.int8_tiled_blocks_per_sm):
        fn.restype = ctypes.c_int
    return lib


def blocks_per_sm(kernel: str, smem: int) -> int:
    """Blocks of ``int8_tiled_kernel`` (K2) or ``sharded_int8_kernel`` (K4)
    that one SM of the current device holds at ``smem`` bytes of dynamic
    shared memory, by CUDA's occupancy calculator."""
    which = {"int8_tiled_kernel": 0, "sharded_int8_kernel": 1}[kernel]
    n = _library().int8_tiled_blocks_per_sm(which, smem)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: CUDA error {-n}")
    return n


def build() -> Path:
    """Compile the kernel library (K2 and K4, ``_build.build``) and return
    its path; ``build.log`` beside it keeps nvcc's ``-Xptxas -v`` report."""
    return _build.build(SOURCE)


@functools.cache
def _bits(rule: Rule, device: torch.device) -> torch.Tensor:
    """:func:`rule_bits` on the device: the kernel's rule, as data.  Kept
    per (rule, device): a copy from host memory at every call would wait
    for the launches already queued on the stream."""
    return torch.from_numpy(rule_bits(rule).view(np.int32)).to(device)


@functools.cache
def launch_args(
    rule: Rule, block_steps: int, height: int, width: int, n_sm: int
) -> tuple[int, ...]:
    """The rule and layout arguments the C entry points share, from
    ``nwords`` to ``smem``, for an output of ``height`` x ``width`` cells
    on a card of ``n_sm`` SMs: the rule's words, radius, depth, centre,
    states and max count, the tile (:func:`tile_shape`), :func:`window`
    and :func:`shared_bytes`.  Kept per argument: the sharded backend
    launches K4 with the same ones on every shard and block."""
    rows, cols = tile_shape(rule, block_steps, height, width, n_sm)
    if ceil_div(height, rows) > MAX_GRID_ROWS:
        raise ValueError(f"an output of {height} rows needs more than {MAX_GRID_ROWS} row tiles")
    return (
        n_words(rule), rule.radius, block_steps, int(rule.include_center),
        rule.states, rule.max_count, rows, cols, *window(rule, block_steps, cols),
        shared_bytes(rule, block_steps, rows, cols),
    )


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
    args = {k: launch_args(rule, k, lh, lw, n_sm) for k in set(ks)}
    fn = _library().int8_tiled_multi_step
    bits = _bits(rule, x.device)
    io = io_bytes(lw, x.data_ptr(), scratch.data_ptr())
    src, dst = x, scratch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for k in ks:
            nwords, *rest = args[k]
            err = fn(
                src.data_ptr(), dst.data_ptr(), bits.data_ptr(), nwords, lh, lw, *rest, io,
                stream,
            )
            if err != 0:
                raise RuntimeError(f"int8_tiled_multi_step launch failed: CUDA error {err}")
            int8_multi_step.launches += 1
            src, dst = dst, src
    return src


int8_multi_step.launches = 0
