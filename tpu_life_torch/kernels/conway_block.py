"""Kernel K5: k clamped Conway steps of a square int8 board in one pass,
hand-written CUDA.

Replaces the TPU kernel ``conway_pallas`` / ``make_kernel`` with its
substep ``_life_substep`` (``experiments/pallas_bench.py``).  The kernel
is ``conway_int8_kernel`` in ``tpu_life_torch/csrc/packed_stripe.cu``,
kernel K1's register tiles with Conway's rule compiled in and a rows
policy that packs the int8 cells to bits as it loads them and unpacks them
as it stores them; it is built with K1 (``packed_stripe.build``) and
called through ``ctypes``.

The function both versions compute: ``k`` steps of Conway's rule (B3/S23)
on a contiguous ``int8[n, n]`` board of 0s and 1s, with every cell outside
the board dead after every step.

The TPU kernel takes ``bh``, the rows of its full-width blocks, and is
right only on a domain: ``n % bh == 0``, ``1 <= k <= bh`` and ``bh + 2k <=
n``.  Past ``bh + 2k > n`` it does not trace, and at ``k > bh`` it returns
a wrong board (an interior block's halo copy starts at a negative row,
which the copy clamps).  :func:`conway_block` takes the same ``bh`` and
refuses every shape outside that domain with ``ValueError``; ``bh`` sets
nothing else.  K5's tiles are K1's, sized to the board by
:func:`tile_shape`: on a board that fills the card, smaller than K1's,
because K5 waits on its bytes where K1 waits on its instructions.

- :func:`conway_block` launches the kernel for a CUDA tensor: one launch
  for ``k <= MAX_DEPTH`` (the experiment's k = 8 among them), else one
  launch per ``MAX_DEPTH`` steps and one for the remainder
  (:func:`launch_depths`).  For a CPU tensor it runs the plain version.
  Any other device raises; nothing falls back.
- :func:`conway_block_plain` is the plain PyTorch version, on any device:
  the CPU tests use it, and ``chip_smoke.py`` holds the kernel to it on
  the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_life_torch.kernels import packed_stripe
from tpu_life_torch.ops import bitlife

MAX_DEPTH = packed_stripe.MAX_BLOCK_STEPS  # substeps a launch: Conway reaches 1 cell a substep
HALO_SHARE = 4  # a tile's halo rows are at most a quarter of its rows (tile_shape)


def check_domain(n: int, bh: int, k: int) -> None:
    """Raise ``ValueError`` unless (n, bh, k) lies in the TPU kernel's
    domain: ``n % bh == 0``, ``1 <= k <= bh`` and ``bh + 2k <= n``."""
    if bh < 1 or n % bh:
        raise ValueError(f"block rows bh={bh} must divide the board's side n={n}")
    if not 1 <= k <= bh:
        raise ValueError(f"k={k} must be in [1, bh={bh}]")
    if bh + 2 * k > n:
        raise ValueError(f"a block and its halos, bh + 2k = {bh + 2 * k}, exceed n={n}")


def launch_depths(k: int) -> list[int]:
    """The substeps of each launch that ``k`` steps take: ``MAX_DEPTH``
    each, then the remainder."""
    blocks, rem = divmod(k, MAX_DEPTH)
    return [MAX_DEPTH] * blocks + ([rem] if rem else [])


def tile_shape(n: int, k: int, n_sm: int) -> tuple[int, int]:
    """``(tile_rows, warp_rows)`` of one launch of ``k`` substeps over an
    ``n x n`` board on a card of ``n_sm`` SMs.

    A board that cannot fill the card takes K1's pick
    (:func:`packed_stripe.tile_shape`) for ``n`` rows of ``ceil(n / 32)``
    words.  On a larger one K5's time is its bytes, not K1's instructions,
    and it is shortest where many small blocks share each SM, so that some
    load while others compute: the tile of fewest rows (4, 8, 16 or 32
    warps of 4 or 8 rows, ties to 8 rows a warp) whose halo of ``2k`` rows
    is at most :data:`HALO_SHARE` of its rows, which re-reads more of the
    board than K1's tiles do (``experiments/stripe_sweep.py k5_tiles``,
    PERF.md)."""
    nwords = -(-n // bitlife.WORD)
    if not packed_stripe.fills_card(k, n, nwords, n_sm):
        return packed_stripe.tile_shape(k, n, nwords, n_sm)
    halo = 2 * k
    total, neg_r = min(
        (warps * r, -r)
        for warps in (4, 8, 16, packed_stripe.TILE_WARPS)
        for r in (packed_stripe.SMALL_WARP_ROWS, packed_stripe.LARGE_WARP_ROWS)
        if HALO_SHARE * halo <= warps * r
    )
    return min(total - halo, n), -neg_r


def conway_block_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """The plain PyTorch version: ``k`` Conway steps, zeros outside."""
    h, w = x.shape
    for _ in range(k):
        p = F.pad(x, (1, 1, 1, 1))
        box = sum(p[i:i + h, j:j + w] for i in range(3) for j in range(3))
        x = ((box == 3) | ((box == 4) & (x == 1))).to(torch.int8)
    return x


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
    ks = launch_depths(k)
    bufs = [out] + ([torch.empty_like(x)] if len(ks) > 1 else [])
    fn = packed_stripe._library().conway_block_int8
    src = x
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        n_sm = packed_stripe.sm_count(torch.cuda.current_device())
        for i, depth in enumerate(ks):
            dst = bufs[i % len(bufs)]
            err = fn(src.data_ptr(), dst.data_ptr(), n, depth, *tile_shape(n, depth, n_sm), stream)
            if err != 0:
                raise RuntimeError(f"conway_block launch failed: CUDA error {err}")
            conway_block.launches += 1
            src = dst
    return src


conway_block.launches = 0
