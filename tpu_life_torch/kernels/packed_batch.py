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
the tiles' halo.  A serving chunk of ``c`` steps is the launches of
:func:`chunk_plan`, the i-th at the offset of the steps before it, so the
budgets stay on the device and a chunk copies nothing from the host.

The kernel has two layouts, and :func:`launch_tiles` picks one by the
board's width:

- **narrow rows** (at most 32 words, 1024 columns: the serve mix's 512^2,
  the reference workload's 1500x500): a row takes a segment of 8, 16 or 32
  lanes (:func:`segment_width`), so a warp register holds 32 / seg rows and
  every lane up to the row's last word is an output word (the clamped edge
  is dead, so no lane is a halo lane).  The sideways reach then sets no
  limit on the depth, and a chunk is one launch of up to
  ``MAX_BLOCK_STEPS // r`` steps, in tiles sized for that halo
  (:func:`segment_tile_shape`);
- **wide rows**: K1's strips and tiles (``packed_stripe.tile_shape`` over
  the batch's rows), in launches of the one-board backend's depth (8).

- :func:`packed_batch_multi_step` launches the kernel for a CUDA tensor
  and raises if it cannot; for a CPU tensor it runs the plain version.
- :func:`packed_batch_multi_step_plain` is the plain PyTorch version, on
  any device: ``bitlife``'s masked packed step per slot under the same
  freeze rule.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpu_life_torch.kernels import packed_stripe
from tpu_life_torch.kernels.packed_stripe import (
    LARGE_WARP_ROWS,
    MAX_BLOCK_STEPS,
    SCHEDULERS_PER_SM,
    SMALL_WARP_ROWS,
    TILE_WARPS,
)
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops import bitlife

MAX_SLOTS = 65535  # the grid's y extent
WARP = 32  # lanes of a warp
SEGMENT_WIDTHS = (8, 16, 32)  # lanes of a narrow row's segment: seg in the CUDA source
H100_SMS = 132  # the SMs a plan assumes where there is no card (its tiles are then unused)


class Tiles(NamedTuple):
    """How one launch lays out its blocks: ``tile_rows`` output rows a
    block, ``warp_rows`` rows a warp (K1's strips) or a segment (narrow
    rows), and ``seg``, the lanes of a narrow row's segment (0: K1's
    strips)."""

    tile_rows: int
    warp_rows: int
    seg: int


class Launch(NamedTuple):
    """One launch of a chunk: ``k`` substeps at ``offset``, in ``tiles``."""

    k: int
    offset: int
    tiles: Tiles


def segment_width(nwords: int) -> int | None:
    """The lanes of a narrow row's segment: the least of 8, 16 and 32 that
    holds the row's ``nwords`` words; None for a wide row."""
    return next((seg for seg in SEGMENT_WIDTHS if nwords <= seg), None)


def segment_tile_shape(
    k: int, slots: int, height: int, nwords: int, n_sm: int, radius: int = 1
) -> Tiles:
    """The tiles of a narrow launch of depth ``k`` over ``slots`` boards of
    ``height`` x ``nwords`` words.  A block of ``w`` warps keeps ``w * (32 //
    seg) * warp_rows`` rows, its output rows and a halo of ``radius * k``
    rows at each end, and a substep costs each warp scheduler about its
    warps' rows in turn: ``ceil(blocks / n_sm) * ceil(w / 4) * warp_rows``.
    The tile minimises that, ties to the fewer rows a segment (more warps
    a scheduler, which hide each other's latency), then to the fewer
    warps in all (the less halo)."""
    seg = segment_width(nwords)
    if seg is None:
        raise ValueError(f"a row of {nwords} words is not narrow (at most {WARP})")
    halo = 2 * radius * k
    best = None
    for warp_rows in (SMALL_WARP_ROWS, LARGE_WARP_ROWS):
        for warps in range(1, TILE_WARPS + 1):
            rows = min(warps * (WARP // seg) * warp_rows - halo, height)
            if rows < 1:
                continue
            blocks = slots * -(-height // rows)
            cost = (-(-blocks // n_sm) * -(-warps // SCHEDULERS_PER_SM) * warp_rows, warp_rows,
                    blocks * warps)
            if best is None or cost < best[0]:
                best = (cost, Tiles(rows, warp_rows, seg))
    return best[1]


@functools.lru_cache(maxsize=256)
def launch_tiles(rule: Rule, k: int, slots: int, height: int, nwords: int, n_sm: int) -> Tiles:
    """The tiles of one launch of depth ``k``: segments on narrow rows
    (:func:`segment_tile_shape`), else K1's strips with
    ``packed_stripe.tile_shape`` over the batch's total rows, so that a
    batch of small boards fills the card as one tall board would (a tile
    never spans two slots).  Cached: the wrapper asks at every launch."""
    if segment_width(nwords) is not None:
        return segment_tile_shape(k, slots, height, nwords, n_sm, rule.radius)
    tile_rows, warp_rows = packed_stripe.tile_shape(k, slots * height, nwords, n_sm, rule.radius)
    return Tiles(min(tile_rows, height), warp_rows, 0)


@functools.lru_cache(maxsize=256)
def chunk_plan(
    rule: Rule, shape: tuple[int, int], chunk_steps: int, slots: int, n_sm: int
) -> tuple[Launch, ...]:
    """The launches of one serving chunk of ``chunk_steps`` steps over
    ``slots`` boards of ``shape``: launches of the most substeps one takes
    and one of the rest, each at the offset of the steps before it, with
    its tiles.  The most is ``MAX_BLOCK_STEPS // radius`` on narrow rows
    (the wrapper's cap: the segments set no sideways limit), so a chunk of
    up to that many steps (the serving default, 16, among them) is one
    launch; on wide rows it is the one-board backend's depth."""
    from tpu_life_torch.backends.cuda_backend import DEFAULT_BLOCK_STEPS

    if chunk_steps < 1:
        raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
    height, nwords = shape[0], bitlife.packed_width(shape[1])
    narrow = segment_width(nwords) is not None
    depth = packed_stripe.clamp_block_steps(rule, MAX_BLOCK_STEPS if narrow else DEFAULT_BLOCK_STEPS)
    plan = []
    for offset in range(0, chunk_steps, depth):
        k = min(depth, chunk_steps - offset)
        plan.append(Launch(k, offset, launch_tiles(rule, k, slots, height, nwords, n_sm)))
    return tuple(plan)


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
    if not 1 <= k <= packed_stripe.clamp_block_steps(rule, MAX_BLOCK_STEPS):
        raise ValueError(f"k must be in [1, {MAX_BLOCK_STEPS // rule.radius}], got {k}")
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
    with torch.cuda.device(x.device):
        n_sm = packed_stripe.sm_count(torch.cuda.current_device())
        launch(x, steps, rule, logical_shape, k, out=out, offset=offset,
               tiles=launch_tiles(rule, k, slots, lh, nwords, n_sm))
    packed_batch_multi_step.launches += 1
    return out


packed_batch_multi_step.launches = 0


def launch(
    x: torch.Tensor,
    steps: torch.Tensor,
    rule: Rule,
    logical_shape: tuple[int, int],
    k: int,
    *,
    out: torch.Tensor,
    offset: int,
    tiles: Tiles,
) -> None:
    """The kernel's launch in ``tiles`` on CUDA tensors that
    :func:`packed_batch_multi_step` checked; raises if the C entry refuses
    it or the launch fails.  It counts nothing: the public wrapper counts
    the launches of the main path."""
    slots, lh, nwords = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = packed_stripe._library().packed_batch_multi_step(
            x.data_ptr(), out.data_ptr(), steps.data_ptr(), slots, offset, lh, nwords,
            logical_shape[1] % bitlife.WORD, k, tiles.tile_rows, tiles.warp_rows, tiles.seg,
            int(bitlife.supports_diamond(rule)), rule.radius, int(rule.include_center),
            int(packed_stripe.compiled_rule(rule)),
            ctypes.byref(packed_stripe.cached_sop_table(rule)), stream,
        )
    if err != 0:
        raise RuntimeError(f"packed_batch_multi_step launch failed: CUDA error {err} "
                           f"(k {k}, {tiles})")

