"""Kernel K5: k clamped Conway steps of a square int8 board in one pass,
hand-written CUDA.

Replaces the TPU kernel ``conway_pallas`` / ``make_kernel`` with its
substep ``_life_substep`` (``experiments/pallas_bench.py``).  The source
is ``tpu_life_torch/csrc/conway_block.cu``; it is compiled by ``nvcc`` for
``sm_90a`` at first use (``kernels._build``) and called through ``ctypes``.

The function both versions compute: ``k`` steps of Conway's rule (B3/S23,
compiled into the kernel) on a contiguous ``int8[n, n]`` board of 0s and
1s, with every cell outside the board dead after every step.

The TPU kernel takes ``bh``, the rows of its full-width blocks, and is
right only on a domain: ``n % bh == 0``, ``1 <= k <= bh`` and ``bh + 2k <=
n``.  Past ``bh + 2k > n`` it does not trace, and at ``k > bh`` it returns
a wrong board (an interior block's halo copy starts at a negative row,
which the copy clamps).  :func:`conway_block` takes the same ``bh`` and
refuses every shape outside that domain with ``ValueError``; ``bh`` sets
nothing else.  K5's tiles are its own: 2-D, a window of 256 columns with
a halo of ``k`` rows and ``ceil4(k)`` columns on each side (a full-width
window of 8192 cells does not fit a Hopper block's shared memory).

- :func:`conway_block` launches the kernel for a CUDA tensor: one launch
  for ``k <= MAX_DEPTH`` (the experiment's k = 8 among them), else one
  launch per ``MAX_DEPTH`` steps and one for the remainder.  For a CPU
  tensor it runs the plain version.  Any other device raises; nothing
  falls back.
- :func:`conway_block_plain` is the plain PyTorch version, on any device:
  the CPU tests use it, and ``chip_smoke.py`` holds the kernel to it on
  the card.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

from tpu_life_torch.kernels import _build

SOURCE = _build.CSRC / "conway_block.cu"
MAX_DEPTH = 32  # substeps a launch (kMaxDepth in the source)
TILE_ROWS = 64  # output rows of a block (kTileRows in the source)
WINDOW_COLS = 256  # window columns of a block (kWords words of 4 cells)


def check_domain(n: int, bh: int, k: int) -> None:
    """Raise ``ValueError`` unless (n, bh, k) lies in the TPU kernel's
    domain: ``n % bh == 0``, ``1 <= k <= bh`` and ``bh + 2k <= n``."""
    if bh < 1 or n % bh:
        raise ValueError(f"block rows bh={bh} must divide the board's side n={n}")
    if not 1 <= k <= bh:
        raise ValueError(f"k={k} must be in [1, bh={bh}]")
    if bh + 2 * k > n:
        raise ValueError(f"a block and its halos, bh + 2k = {bh + 2 * k}, exceed n={n}")


def tile_cols(k: int) -> int:
    """Output columns of a block at depth ``k``: the window less a halo of
    ``ceil4(k)`` columns on each side."""
    return WINDOW_COLS - 2 * (-(-k // 4) * 4)


def conway_block_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """The plain PyTorch version: ``k`` Conway steps, zeros outside."""
    h, w = x.shape
    for _ in range(k):
        p = F.pad(x, (1, 1, 1, 1))
        box = sum(p[i:i + h, j:j + w] for i in range(3) for j in range(3))
        x = ((box == 3) | ((box == 4) & (x == 1))).to(torch.int8)
    return x


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.library(SOURCE)
    lib.conway_block.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.conway_block.restype = ctypes.c_int
    return lib


def build() -> Path:
    """Compile the kernel library (``_build.build``) and return its path;
    ``build.log`` beside it keeps nvcc's ``-Xptxas -v`` report."""
    return _build.build(SOURCE)


def conway_block(
    x: torch.Tensor, bh: int, k: int, *, out: torch.Tensor | None = None
) -> torch.Tensor:
    """``k`` clamped Conway steps of the square int8 board ``x``, the
    function of ``conway_pallas(n, bh, k)`` on its domain (``bh`` checks the
    domain only).  ``x`` is left as it was.

    On a CUDA tensor the result is written to ``out`` (allocated when None,
    a second board on ``x``'s device) and returned; with more than one
    launch the launches ping-pong between ``out`` and a scratch board and
    the function returns whichever holds the result.  On a CPU tensor it
    returns the plain version's result.
    """
    if x.dtype != torch.int8:
        raise TypeError(f"x must be an int8 board, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] != x.shape[1]:
        raise ValueError(f"x must be a square board, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[0]
    check_domain(n, bh, k)
    if x.device.type == "cpu":
        return conway_block_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"conway_block runs on cuda or cpu tensors, got {x.device}")
    if out is None:
        out = torch.empty_like(x)
    if out.shape != x.shape or out.dtype != torch.int8 or not out.is_contiguous():
        raise ValueError("out must be a contiguous int8 board of x's shape")
    if out.device != x.device or out.data_ptr() == x.data_ptr():
        raise ValueError("out must be a second board on x's device")
    blocks, rem = divmod(k, MAX_DEPTH)
    ks = [MAX_DEPTH] * blocks + ([rem] if rem else [])
    bufs = [out] + ([torch.empty_like(x)] if len(ks) > 1 else [])
    fn = _library().conway_block
    src = x
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i, depth in enumerate(ks):
            dst = bufs[i % len(bufs)]
            err = fn(src.data_ptr(), dst.data_ptr(), n, depth, stream)
            if err != 0:
                raise RuntimeError(f"conway_block launch failed: CUDA error {err}")
            conway_block.launches += 1
            src = dst
    return src


conway_block.launches = 0
