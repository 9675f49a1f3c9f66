"""Kernel K3: one block of k bit-sliced steps on one shard, hand-written CUDA.

Replaces the TPU kernel ``make_pallas_sharded_stripe_block`` and its body
``_packed_tile_advance`` with a shard's ``row0``
(``tpu_life/backends/pallas_backend.py``): the per-shard stepper of the
sharded backend for packed rules.  It is K1 per shard and lives in K1's
source, ``tpu_life_torch/csrc/packed_stripe.cu`` (``sharded_stripe_kernel``
and ``sharded_diamond_kernel``), running K1's register tiles over the
shard's three buffers; it is built with K1 by ``nvcc`` for ``sm_90a`` at
first use and called through ``ctypes``.  As K1 it is bound by integer
issue; the wrapper sizes its tiles to the shard's rows as K1's does
(``packed_stripe.tile_shape``) and, in the Moore modes, picks Conway's rule
compiled in where the rule's minimized SOP is Conway's.

The function both versions compute: ``block(top, chunk, bot, row0) ->
chunk'``, ``block_steps`` steps of one shard's packed chunk
``int32[hl, ceil(lw / 32)]`` (``bitlife.pack_np`` words) whose halos
``top`` and ``bot`` hold the ``r * block_steps`` rows above and below it,
``row0`` being the board row of ``top[0]``.  Three modes, by the rule:

- Moore, clamped (life-like rules): rows outside ``[0, lh)`` dead;
- the von Neumann diamond, clamped (2-state, radius 1 or 2, the depth at
  most ``32 // r``);
- Moore on the torus (life-like ``:T``): no row is masked (the halos are
  real rows of the closed ring), the columns wrap at the logical width.

- :func:`sharded_stripe_block` launches the kernel for CUDA tensors, and
  runs the plain version for CPU tensors.  Any other device raises;
  nothing falls back.
- :func:`sharded_stripe_block_plain` is the plain version: the sharded
  backend's per-shard block in plain ops (``parallel.halo.make_shard_block``).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_life_torch.kernels import packed_stripe
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.parallel import halo

MOORE, TORUS, DIAMOND = 0, 1, 2  # the kernel's modes (sharded_stripe_block's `mode`)


def mode_of(rule: Rule) -> int:
    """The kernel mode of ``rule``; raises for a rule K3 does not run."""
    if bitlife.supports(rule):
        return MOORE
    if bitlife.supports_torus(rule):
        return TORUS
    if bitlife.supports_diamond(rule):
        return DIAMOND
    raise ValueError(
        f"the sharded stripe kernel runs life-like rules (clamped or torus) and "
        f"clamped 2-state von Neumann rules of radius <= 2 only, got {rule}"
    )


def sharded_stripe_block_plain(
    top: torch.Tensor,
    chunk: torch.Tensor,
    bot: torch.Tensor,
    row0: int,
    rule: Rule,
    logical_shape: tuple[int, int],
    block_steps: int,
) -> torch.Tensor:
    """The plain PyTorch version, on any device: stack, ``block_steps``
    masked (or torus) packed steps, keep the chunk's rows."""
    block = halo.make_shard_block(
        rule, tuple(logical_shape), block_steps, packed=True,
        torus=rule.boundary == "torus",
    )
    return block(top, chunk, bot, row0)


def _check(x: torch.Tensor, shape: tuple[int, int], name: str) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 words, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, want {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sharded_stripe_block(
    top: torch.Tensor,
    chunk: torch.Tensor,
    bot: torch.Tensor,
    row0: int,
    rule: Rule,
    logical_shape: tuple[int, int],
    block_steps: int,
    *,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``block_steps`` steps of one shard (see the module docstring).

    On CUDA tensors the kernel writes ``out`` (allocated when None; a
    buffer other than the inputs) on the current stream of the chunk's
    device, with that device current, and returns it.  On CPU tensors it
    returns the plain version's new tensor.
    """
    mode_of(rule)
    depth = packed_stripe.clamp_block_steps(rule, block_steps)  # r * k <= 32, as K1
    if not 1 <= block_steps <= depth:
        raise ValueError(
            f"block_steps must be in [1, {depth}] for radius {rule.radius}, got {block_steps}"
        )
    hl, nwords = chunk.shape
    if nwords != bitlife.packed_width(logical_shape[1]):
        raise ValueError(
            f"chunk has {nwords} words a row, want {bitlife.packed_width(logical_shape[1])} "
            f"for width {logical_shape[1]}"
        )
    fr = halo.halo_depth(rule, block_steps)
    _check(chunk, (hl, nwords), "chunk")
    _check(top, (fr, nwords), "top")
    _check(bot, (fr, nwords), "bot")
    devices = {top.device, chunk.device, bot.device}
    if len(devices) != 1:
        raise ValueError(f"top, chunk and bot must share a device, got {sorted(map(str, devices))}")
    if chunk.device.type == "cpu":
        return sharded_stripe_block_plain(top, chunk, bot, row0, rule, logical_shape, block_steps)
    if chunk.device.type != "cuda":
        raise ValueError(f"sharded_stripe_block runs on cuda or cpu tensors, got {chunk.device}")
    if out is None:
        out = torch.empty_like(chunk)
    _check(out, (hl, nwords), "out")
    if out.device != chunk.device or out.data_ptr() in (
        top.data_ptr(), chunk.data_ptr(), bot.data_ptr()
    ):
        raise ValueError("out must be a buffer of its own on the chunk's device")
    lh, lw = logical_shape
    mode = mode_of(rule)
    compiled = packed_stripe.compiled_rule(rule)
    lib = packed_stripe._library()
    with torch.cuda.device(chunk.device):
        tiles = packed_stripe.launch_tile_shape(rule, block_steps, hl, nwords)
        stream = torch.cuda.current_stream(chunk.device).cuda_stream
        err = lib.sharded_stripe_block(
            top.data_ptr(), chunk.data_ptr(), bot.data_ptr(), out.data_ptr(),
            hl, fr, row0, lh, lw, block_steps, *tiles, mode, rule.radius,
            int(rule.include_center), int(compiled),
            ctypes.byref(packed_stripe.cached_sop_table(rule)), stream,
        )
    if err != 0:
        raise RuntimeError(f"sharded_stripe_block launch failed: CUDA error {err}")
    sharded_stripe_block.launches += 1
    return out


sharded_stripe_block.launches = 0
