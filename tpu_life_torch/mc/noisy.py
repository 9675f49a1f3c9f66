"""Noisy-Life: a deterministic 2-state rule composed with per-cell flips
(from ``tpu_life/mc/noisy.py``).

The step is ``flip(base_step(board))`` where ``flip`` inverts each cell
independently with probability ``rule.flip_p``, drawn from the counter
stream's ``SUB_NOISE`` substream at the cell's absolute step — so the
noise is as reproducible as the rule, and the deterministic half reuses
the existing executors untouched (a :class:`NoisyRule` carries its base
rule's structural fields).

``flip_p`` is frozen in the rule spec (``noisy:<p>/<base>``), so the
endpoint probabilities specialize at build time: p = 0 is the bare base
step, p = 1 an exact unconditional inversion that takes no draw.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_life_torch.mc import prng
from tpu_life_torch.models.rules import NoisyRule


def make_noisy_step(xp, rule: NoisyRule, *, uniforms=None, base=None):
    """``fn(board, k0, k1, step) -> board`` for numpy or torch.

    On numpy the base step is the oracle (``ops.reference.step_np``).  On
    torch it is ``base`` (``ops.stencil.make_step`` when None; the ``cuda``
    backend passes kernel K2) and the draws come from ``uniforms``
    (``prng.cell_uniforms_torch`` when None; the ``cuda`` backend passes
    kernel K7).  The executors are bit-identical, so the composed step is
    too.
    """
    if xp is np:
        from tpu_life_torch.ops.reference import step_np

        base = lambda b: step_np(b, rule)  # noqa: E731
    elif base is None:
        from tpu_life_torch.ops.stencil import make_step

        base = make_step(rule)
    p = float(rule.flip_p)
    if p <= 0.0:
        return lambda board, k0, k1, step: base(board)
    h_thr = prng.threshold_u32(p)

    if xp is np:
        def step(board, k0, k1, step_idx):
            nxt = base(board)
            if p >= 1.0:
                return (1 - nxt).astype(nxt.dtype)
            shape = (nxt.shape[-2], nxt.shape[-1])
            u = prng.cell_uniforms(shape, k0, k1, step_idx, prng.SUB_NOISE)
            flip = u < np.uint32(h_thr)
            return np.where(flip, (1 - nxt).astype(nxt.dtype), nxt)

        return step

    uniforms = uniforms or prng.cell_uniforms_torch
    thr = prng.as_i32(h_thr)

    def step(board, k0, k1, step_idx):
        nxt = base(board)
        if p >= 1.0:
            return 1 - nxt
        u = uniforms(tuple(nxt.shape), k0, k1, step_idx, prng.SUB_NOISE, device=nxt.device)
        return torch.where(prng.ult(u, thr), 1 - nxt, nxt)

    return step


def make_noisy_batch_step(rule: NoisyRule, *, uniforms=None, base=None):
    """``fn(boards, state, offset) -> boards``: sweep ``offset`` of a chunk
    over a batch of int8 boards ``[S, h, w]``, every slot stepped (the
    caller keeps a frozen slot's board), its flips drawn under each slot's
    key and counter in ``state`` (``prng.SlotState``).  The base step runs
    over the whole batch (``base``; ``ops.stencil.make_step`` when None),
    and the draws come from ``uniforms`` (the batch form ``fn(shape, state,
    substream, offset=)``: K7's batch mode, or
    ``prng.cell_uniforms_batch_torch`` when None)."""
    if base is None:
        from tpu_life_torch.ops.stencil import make_step

        base = make_step(rule)
    p = float(rule.flip_p)
    if p <= 0.0:
        return lambda boards, state, offset: base(boards)
    uniforms = uniforms or prng.cell_uniforms_batch_torch
    thr = prng.as_i32(prng.threshold_u32(p))

    def step(boards, state, offset):
        nxt = base(boards)
        if p >= 1.0:
            return 1 - nxt
        u = uniforms(tuple(nxt.shape[-2:]), state, prng.SUB_NOISE, offset=offset)
        return torch.where(prng.ult(u, thr), 1 - nxt, nxt)

    return step
