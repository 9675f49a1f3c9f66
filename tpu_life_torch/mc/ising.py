"""Checkerboard Metropolis–Hastings for the 2-D Ising model (from
``tpu_life/mc/ising.py``).

Color the lattice like a checkerboard: within one color no two cells are
coupled (the radius-1 von Neumann neighbors of any cell all have the other
parity), so updating a whole color at once is *exactly* sequential
single-site Metropolis restricted to that color.  One "step" of the rule
is one full sweep: the parity-0 half-update, then (reading the
just-updated opposite color) the parity-1 half-update.

Acceptance without floats on the device: with J = 1 and 4 neighbors,
dE = 2 * s * sum(neighbor spins) takes only values {-8, -4, 0, 4, 8}, so
``min(1, exp(-dE/T))`` becomes a host-computed **uint32[5] threshold
table** indexed by ``(s * nsum + 4) >> 1``; the device compares the
cell's counter-based draw against its entry (dE <= 0 force-accepts
exactly).  The on-device step is pure integer work, bit-identical between
numpy and torch.

:func:`sweep` runs on numpy (a copy of the JAX package's) or on torch
(the int8 roll path: draws for the whole lattice each half, as the JAX
roll path draws them, from ``prng.cell_uniforms_torch`` or from kernel
K7); :func:`sweep_batch` is its batched form over the slots of a serving
batch, with draws from K7's batch mode or its plain version.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_life_torch.mc import prng

#: Onsager's exact critical temperature, 2 / ln(1 + sqrt(2)).
T_CRITICAL = 2.0 / math.log(1.0 + math.sqrt(2.0))

#: dE values by table index i = (s * nsum + 4) >> 1.
_DELTA_E = (-8, -4, 0, 4, 8)


def acceptance_thresholds(temperature: float) -> np.ndarray:
    """uint32[5] Metropolis acceptance table for one temperature.

    Entry i covers dE = _DELTA_E[i]; accept iff dE <= 0 (forced on
    device) or u32 < entry.  T = 0 is exact: only dE <= 0 moves accept.
    Host-side float math happens once per session here, so every
    executor shares the identical integer table.
    """
    t = float(temperature)
    if not np.isfinite(t) or t < 0.0:
        raise ValueError(f"temperature must be finite and >= 0, got {temperature!r}")
    out = np.zeros(5, dtype=np.uint32)
    for i, de in enumerate(_DELTA_E):
        if de <= 0:
            out[i] = 0xFFFFFFFF  # informational; device force-accepts
        elif t > 0.0:
            out[i] = prng.threshold_u32(math.exp(-de / t))
    return out


def _neighbor_spin_sum(xp, spins):
    """int32 sum of the 4 torus neighbors (roll = periodic wraparound)."""
    return (
        xp.roll(spins, 1, 0)
        + xp.roll(spins, -1, 0)
        + xp.roll(spins, 1, 1)
        + xp.roll(spins, -1, 1)
    )


def _half_update_np(board, k0, k1, step, parity, substream, thresholds):
    h, w = board.shape[-2], board.shape[-1]
    s = board.astype(np.int32) * 2 - 1  # {0,1} -> {-1,+1}
    nsum = _neighbor_spin_sum(np, s)
    # dE = 2*s*nsum in {-8,-4,0,4,8}; index i = (s*nsum + 4) >> 1 in 0..4
    idx = (s * nsum + 4) >> 1
    u = prng.cell_uniforms((h, w), k0, k1, step, substream)
    accept = (idx <= 2) | (u < thresholds[idx])
    rows = np.arange(h, dtype=np.int32)[:, None]
    cols = np.arange(w, dtype=np.int32)[None, :]
    on_color = ((rows + cols) & 1) == parity
    flip = accept & on_color
    return np.where(flip, (1 - board).astype(board.dtype), board)


def _half_update_torch(board, u, parity, thr3, thr4):
    """The torch form on int8 boards (``[h, w]``, or a batch ``[S, h, w]``):
    the table index as numpy computes it, and entries 3 and 4 (the only
    ones read: i <= 2 force-accepts) compared unsigned against the int32
    bit patterns of the draws ``u``.  ``thr3``/``thr4`` are int32 Python
    ints, or int32 tensors of one a slot ([S, 1, 1])."""
    h, w = board.shape[-2:]
    s = board.to(torch.int32) * 2 - 1
    nsum = (torch.roll(s, 1, -2) + torch.roll(s, -1, -2)
            + torch.roll(s, 1, -1) + torch.roll(s, -1, -1))
    idx = (s * nsum + 4) >> 1
    accept = (idx <= 2) | ((idx == 3) & prng.ult(u, thr3)) | ((idx == 4) & prng.ult(u, thr4))
    rows = torch.arange(h, dtype=torch.int32, device=board.device)[:, None]
    cols = torch.arange(w, dtype=torch.int32, device=board.device)[None, :]
    on_color = ((rows + cols) & 1) == parity
    return torch.where(accept & on_color, 1 - board, board)


_PARITIES = ((0, prng.SUB_EVEN), (1, prng.SUB_ODD))


def sweep(xp, board, k0, k1, step, thresholds, *, uniforms=None):
    """One full Metropolis sweep (both checkerboard half-updates).

    ``xp`` is numpy (``board`` int8 {0,1}; ``k0``/``k1``/``step`` uint32
    scalars) or torch (``board`` an int8 tensor; ``step`` a Python int;
    draws from ``uniforms``, ``prng.cell_uniforms_torch`` when None);
    ``thresholds`` is the uint32[5] table of :func:`acceptance_thresholds`.
    """
    if xp is np:
        board = _half_update_np(board, k0, k1, step, 0, prng.SUB_EVEN, thresholds)
        return _half_update_np(board, k0, k1, step, 1, prng.SUB_ODD, thresholds)
    uniforms = uniforms or prng.cell_uniforms_torch
    thr3, thr4 = prng.as_i32(thresholds[3]), prng.as_i32(thresholds[4])
    for parity, substream in _PARITIES:
        u = uniforms(tuple(board.shape), k0, k1, step, substream, device=board.device)
        board = _half_update_torch(board, u, parity, thr3, thr4)
    return board


def sweep_batch(boards, state, offset: int, *, uniforms=None):
    """Sweep ``offset`` of a chunk over a batch of int8 boards ``[S, h, w]``
    on the roll path, each slot under its key, counter and table in
    ``state`` (``prng.SlotState``), its draws from ``uniforms`` (the batch
    form ``fn(shape, state, substream, offset=)``: K7's batch mode, or
    ``prng.cell_uniforms_batch_torch`` when None).  Every slot is stepped;
    the caller keeps a frozen slot's board (its draws may be zeros)."""
    uniforms = uniforms or prng.cell_uniforms_batch_torch
    thr3, thr4 = state.thr[:, 3].view(-1, 1, 1), state.thr[:, 4].view(-1, 1, 1)
    for parity, substream in _PARITIES:
        u = uniforms(tuple(boards.shape[-2:]), state, substream, offset=offset)
        boards = _half_update_torch(boards, u, parity, thr3, thr4)
    return boards


def magnetization(board: np.ndarray) -> float:
    """|mean spin| in [0, 1] — ~1 ordered (low T), ~0 disordered (high T)."""
    spins = np.asarray(board, np.int64) * 2 - 1
    return abs(float(spins.mean()))
