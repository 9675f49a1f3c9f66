"""K1's batch mode: every slot of a serving batch in one launch.

It has no Pallas counterpart: it computes the chunk of the JAX serving
tier's batched engine (``VmapEngine`` in ``tpu_life/serve/engine.py``, a
``lax.scan`` over a vmapped step whose freeze mask holds a slot once its
budget is spent), for the rules kernel K1 takes (``packed_stripe``:
clamped life-like Moore rules, and clamped 2-state von Neumann rules of
radius <= 2).  The source is K1's, ``tpu_life_torch/csrc/packed_stripe.cu``
(``packed_batch_multi_step``): K1's tiles with the slot on the grid's y
axis.

The function both versions compute: for a batch ``x`` of packed boards,
int32 ``(slots, lh, ceil(lw / 32))`` in the ``bitlife.pack_np`` layout,
and a device int32 vector ``steps`` of per-slot budgets, slot ``s``
advances ``n_s = min(k, max(steps[s] - offset, 0))`` masked steps, each
equal to ``bitlife.make_masked_packed_step(rule, (lh, lw))``; a slot of
``n_s = 0`` is copied through.  ``k`` is the launch's depth, which sets
the tiles' halo.  A serving chunk of ``c`` steps is launches of depth at
most :func:`packed_stripe.clamp_block_steps`, the i-th at the offset of
the steps before it, so the budgets stay on the device and a chunk copies
nothing from the host.

- :func:`packed_batch_multi_step` launches the kernel for a CUDA tensor
  and raises if it cannot; for a CPU tensor it runs the plain version.
- :func:`packed_batch_multi_step_plain` is the plain PyTorch version, on
  any device: ``bitlife``'s masked packed step per slot under the same
  freeze rule.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_life_torch.kernels import packed_stripe
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops import bitlife

MAX_SLOTS = 65535  # the grid's y extent


def supports(rule: Rule) -> bool:
    """Whether K1 (and so its batch mode) takes ``rule``."""
    return bitlife.supports(rule) or bitlife.supports_diamond(rule)


def slot_steps(steps: torch.Tensor, k: int, offset: int) -> list[int]:
    """The substeps each slot takes in one launch: ``min(k, max(steps -
    offset, 0))``, read to the host."""
    return (steps.to(torch.int64) - offset).clamp(0, k).tolist()


def _check(x: torch.Tensor, steps: torch.Tensor, logical_shape: tuple[int, int], name: str) -> None:
    lh, lw = logical_shape
    want = (lh, bitlife.packed_width(lw))
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 words, got {x.dtype}")
    if x.dim() != 3 or tuple(x.shape[1:]) != want:
        raise ValueError(
            f"{name} has shape {tuple(x.shape)}, want (slots, {want[0]}, {want[1]}) for "
            f"{lh}x{lw} boards"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if steps.dtype != torch.int32 or tuple(steps.shape) != (x.shape[0],):
        raise ValueError(f"steps must be int32 of shape ({x.shape[0]},), got {steps.dtype} "
                         f"{tuple(steps.shape)}")


def packed_batch_multi_step_plain(
    x: torch.Tensor,
    steps: torch.Tensor,
    rule: Rule,
    logical_shape: tuple[int, int],
    k: int,
    *,
    out: torch.Tensor,
    offset: int = 0,
) -> torch.Tensor:
    """The plain PyTorch version, on ``x``'s device: slot by slot,
    ``bitlife.multi_step_packed`` of its substeps, or a copy.  Writes and
    returns ``out``."""
    for s, n in enumerate(slot_steps(steps, k, offset)):
        out[s] = x[s] if n == 0 else bitlife.multi_step_packed(
            x[s], rule=rule, steps=n, logical_shape=tuple(logical_shape)
        )
    return out


def packed_batch_multi_step(
    x: torch.Tensor,
    steps: torch.Tensor,
    rule: Rule,
    logical_shape: tuple[int, int],
    k: int,
    *,
    out: torch.Tensor,
    offset: int = 0,
) -> torch.Tensor:
    """One launch of K1's batch mode from ``x`` into ``out`` (a second
    buffer of ``x``'s shape on its device): slot ``s`` advances
    ``min(k, max(steps[s] - offset, 0))`` masked steps, on the current
    stream.  ``k`` is at most the rule's clamped block depth.  On a CPU
    tensor it runs the plain version; any other device raises, and a
    failed build or launch raises: nothing falls back.  Returns ``out``."""
    if not supports(rule):
        raise ValueError(
            f"K1's batch mode runs clamped life-like rules and clamped 2-state von "
            f"Neumann rules of radius <= 2 only, got {rule}"
        )
    if not 1 <= k <= packed_stripe.clamp_block_steps(rule, packed_stripe.MAX_BLOCK_STEPS):
        raise ValueError(f"k must be in [1, {packed_stripe.MAX_BLOCK_STEPS // rule.radius}], got {k}")
    if offset < 0:
        raise ValueError(f"offset must be >= 0, got {offset}")
    _check(x, steps, logical_shape, "x")
    _check(out, steps, logical_shape, "out")
    if not 1 <= x.shape[0] <= MAX_SLOTS:
        raise ValueError(f"a batch holds 1..{MAX_SLOTS} slots, got {x.shape[0]}")
    if out.device != x.device or steps.device != x.device or out.data_ptr() == x.data_ptr():
        raise ValueError("out and steps must lie on x's device, and out must be a second buffer")
    if x.device.type == "cpu":
        return packed_batch_multi_step_plain(x, steps, rule, logical_shape, k, out=out,
                                             offset=offset)
    if x.device.type != "cuda":
        raise ValueError(f"packed_batch_multi_step runs on cuda or cpu tensors, got {x.device}")
    slots, lh, nwords = x.shape
    lw = logical_shape[1]
    diamond = bitlife.supports_diamond(rule)
    lib = packed_stripe._library()
    # tiles from the batch's total rows, so that a batch of small boards
    # fills the card as one tall board would; a tile never spans two slots
    tile_rows, warp_rows = packed_stripe.launch_tile_shape(rule, k, slots * lh, nwords)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.packed_batch_multi_step(
            x.data_ptr(), out.data_ptr(), steps.data_ptr(), slots, offset, lh, nwords,
            lw % bitlife.WORD, k, min(tile_rows, lh), warp_rows, int(diamond), rule.radius,
            int(rule.include_center), int(packed_stripe.compiled_rule(rule)),
            ctypes.byref(packed_stripe.cached_sop_table(rule)), stream,
        )
    if err != 0:
        raise RuntimeError(f"packed_batch_multi_step launch failed: CUDA error {err}")
    packed_batch_multi_step.launches += 1
    return out


packed_batch_multi_step.launches = 0

