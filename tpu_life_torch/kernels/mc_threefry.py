"""Kernels K6 and K7: the stochastic tier's Threefry, hand-written CUDA.

No Pallas kernel precedes them: the JAX package runs the tier as
``jax.jit`` over ``lax.scan`` (``tpu_life/mc/engine.py``:
``MCPackedDeviceRunner`` over ``mc/packed.py::make_sweep``,
``MCDeviceRunner`` over ``mc/ising.py::sweep``), which XLA fuses into one
pass a half-sweep.  PyTorch has no call that hashes by a cell's
coordinates, and as plain ops one Threefry evaluation is some 112
launches, each writing a whole board; so the hash is two kernels of
``tpu_life_torch/csrc/mc_threefry.cu``, compiled by ``nvcc`` for ``sm_90a``
at first use (``kernels._build``) and called through ``ctypes``.

- :func:`cell_uniforms` (K7): one word of the hash for every cell of an
  ``[h, w]`` block at ``(k0, k1, step, substream, origin)`` — the draws of
  the int8 roll path, of the noisy flip and of seeded staging.  Its plain
  version is :func:`cell_uniforms_plain` (``prng.cell_uniforms_torch``).
- :func:`packed_metropolis_half` (K6): one checkerboard half-sweep of the
  packed spins, one thread a word: the neighbour count and the cells whose
  move a draw decides (dE > 0) in registers, then only those cells hashed,
  spread evenly over the warp's lanes, with one compare each.  A launch
  whose cells all lie below 2^32 (:func:`narrow_launch`) takes the narrow
  instance (32-bit index, Threefry's round 1 hoisted), any other the wide
  one.  Its plain version is :func:`packed_metropolis_half_plain`
  (``mc.packed.half_sweep_torch``).

Each has a batch mode for the serving tier's stochastic engines (the JAX
package's ``MCPackedVmapEngine`` and ``MCVmapEngine``): every slot of a
batch of boards in one launch, each slot's key halves, absolute sweep
counter, acceptance table and remaining budget read from device tensors
(``prng.SlotState``), a frozen slot (budget at most the launch's
``offset`` into the chunk) passed over:

- :func:`cell_uniforms_batch` (K7's batch mode): word 0 of the hash for
  every cell of ``[S, h, w]``, zeros for a frozen slot; its plain version
  is :func:`cell_uniforms_batch_plain` (``prng.cell_uniforms_batch_torch``).
- :func:`packed_metropolis_half_batch` (K6's batch mode): a half-sweep of
  every live slot, a frozen one copied through; its plain version is
  :func:`packed_metropolis_half_batch_plain`
  (``mc.packed.half_sweep_batch_torch``).

Each launches its kernel for a CUDA tensor and runs its plain version for a
CPU one; any other device raises, and nothing falls back.  Each counts its
launches (``cell_uniforms.launches``, ``packed_metropolis_half.launches``,
``cell_uniforms_batch.launches``, ``packed_metropolis_half_batch.launches``).
Both are bound by integer operations on an H100: of the
:data:`OPS_PER_DRAW` that word 0 of a draw needs, the
:data:`ALU_OPS_PER_DRAW` rotates and xors issue only on the integer pipe
(the adds also as IMAD), so K7 at 16384^2 is bound by about 0.59 ms; K6 by
the draws the table needs (the cells with dE > 0), the only ones it
hashes, PERF.md §6.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from tpu_life_torch.kernels import _build
from tpu_life_torch.mc import packed, prng
from tpu_life_torch.mc.prng import SlotState

SOURCE = _build.CSRC / "mc_threefry.cu"
#: 32-bit integer operations a cell that word 0 of one Threefry-2x32/20
#: evaluation needs, counted from the hash's data flow.  The rotates and
#: xors (integer pipe only): round 1 rotates x1 = c1 + k1, the same for
#: every cell of a launch, and round 20's rotate and xor feed only word 1,
#: which leaves 18 rotates and 19 xors.
ALU_OPS_PER_DRAW = 18 + 19
#: ... and the adds: the x0 add of each of the 20 rounds (round 1's folds
#: the counter's key, c0 + (k0 + x1), into one add of a uniform), the 5 key
#: injections into x0 and the 4 into x1 that word 0 reads (the round
#: constant folded into the key): 29, on either pipe.
OPS_PER_DRAW = ALU_OPS_PER_DRAW + 20 + 5 + 4


def build() -> Path:
    """Compile the kernel library (K6 and K7, ``_build.build``) and return
    its path; ``build.log`` beside it keeps nvcc's ``-Xptxas -v`` report."""
    return _build.build(SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.library(SOURCE)
    lib.mc_cell_uniforms.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mc_packed_metropolis_half.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_ulonglong, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mc_packed_metropolis_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mc_cell_uniforms_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    for fn in (lib.mc_cell_uniforms, lib.mc_packed_metropolis_half,
               lib.mc_packed_metropolis_batch, lib.mc_cell_uniforms_batch):
        fn.restype = ctypes.c_int
    return lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


#: The plain PyTorch version of K7, on any device.
cell_uniforms_plain = prng.cell_uniforms_torch


def cell_uniforms(
    shape: tuple[int, int], k0: int, k1: int, step: int, substream: int, *, origin: int = 0,
    device: str | torch.device, word: int = 0,
) -> torch.Tensor:
    """Word ``word`` (0, or 1) of the hash for every cell of an ``[h, w]``
    block whose cell (0, 0) has flat index ``origin``, at absolute ``step``
    and ``substream`` under the run's key halves ``k0``/``k1``: an
    int32[h, w] tensor of the uint32 draws' bit patterns on ``device``.
    Word 0 is ``prng.cell_uniforms``; word 1 is the state draw of seeded
    staging.  Kernel K7 on a CUDA device, the plain version on the CPU."""
    device = torch.device(device)
    h, w = (int(v) for v in shape)
    if word not in (0, 1):
        raise ValueError(f"word must be 0 or 1, got {word}")
    if device.type == "cpu":
        return cell_uniforms_plain((h, w), k0, k1, step, substream, origin=origin,
                                   device=device, word=word)
    if device.type != "cuda":
        raise ValueError(f"cell_uniforms runs on cuda or cpu devices, got {device}")
    prng.check_block(h * w, int(origin))
    out = torch.empty((h, w), dtype=torch.int32, device=device)
    if h * w == 0:
        return out
    with torch.cuda.device(device):
        err = _library().mc_cell_uniforms(
            out.data_ptr(), h * w, prng.as_u32(k0), prng.as_u32(k1),
            prng.counter_word(step, substream), int(origin), word, _stream(device),
        )
    if err != 0:
        raise RuntimeError(f"mc_cell_uniforms launch failed: CUDA error {err}")
    cell_uniforms.launches += 1
    return out


cell_uniforms.launches = 0


def packed_metropolis_half_plain(
    x: torch.Tensor, parity: int, k0: int, k1: int, step: int, thr3: int, thr4: int, *,
    width: int, origin: int = 0, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of K6 on any device
    (``mc.packed.half_sweep_torch``).  It returns a new tensor and ignores
    ``out``, which it takes so that it and :func:`packed_metropolis_half`
    are interchangeable."""
    return packed.half_sweep_torch(x, parity, k0, k1, step, thr3, thr4, width=width, origin=origin)


def narrow_launch(height: int, width: int, origin: int) -> bool:
    """Whether K6's narrow instance serves a half-sweep of an ``[height,
    width]`` board whose cell (0, 0) has flat index ``origin``: every cell
    index ``origin + r * width + c`` lies in the first 2^32-cell block of
    draws, so it is its own 32-bit low word and the draw takes the run's
    key (``prng.derive_wide_keys`` leaves block 0's key as it is)."""
    return int(origin) + int(height) * int(width) <= prng.MAX_NARROW_CELLS


def _check_words(x: torch.Tensor, width: int, name: str) -> None:
    if x.dtype != torch.int32 or x.dim() != 2:
        raise TypeError(f"{name} must be int32 packed words [H, ceil(W/32)], got {x.dtype} "
                        f"{tuple(x.shape)}")
    if x.shape[1] != packed.packed_width(width):
        raise ValueError(f"{name} has {x.shape[1]} words a row, want {packed.packed_width(width)} "
                         f"for width {width}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def packed_metropolis_half(
    x: torch.Tensor, parity: int, k0: int, k1: int, step: int, thr3: int, thr4: int, *,
    width: int, origin: int = 0, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One checkerboard half-sweep of parity ``parity`` of the packed board
    ``x`` (int32[H, ceil(W/32)] words, ``width`` = W, H and W even) at
    absolute sweep ``step``, against the acceptance table's entries
    ``thr3``/``thr4`` (uint32 values or their int32 bit patterns), the
    board's cell (0, 0) at flat index ``origin``.

    On a CUDA tensor kernel K6 writes the result into ``out`` (a second
    buffer of ``x``'s shape on its device, allocated when None) and returns
    it; ``x`` is left as it was.  The launch takes K6's narrow instance
    where :func:`narrow_launch` holds and the wide one where it does not.
    On a CPU tensor it returns the plain version's result.
    """
    if parity not in (0, 1):
        raise ValueError(f"parity must be 0 or 1, got {parity}")
    h = x.shape[0]
    if h % 2 or width % 2 or h < 2 or width < 2:
        raise ValueError(f"the packed half-sweep needs even dimensions, got {h}x{width}")
    if origin < 0:
        raise ValueError(f"origin must be >= 0, got {origin}")
    _check_words(x, width, "x")
    if x.device.type == "cpu":
        return packed_metropolis_half_plain(x, parity, k0, k1, step, thr3, thr4,
                                            width=width, origin=origin)
    if x.device.type != "cuda":
        raise ValueError(f"packed_metropolis_half runs on cuda or cpu tensors, got {x.device}")
    if out is None:
        out = torch.empty_like(x)
    _check_words(out, width, "out")
    if out.shape != x.shape or out.device != x.device or out.data_ptr() == x.data_ptr():
        raise ValueError("out must be a second buffer of x's shape on x's device")
    substream = prng.SUB_ODD if parity else prng.SUB_EVEN
    with torch.cuda.device(x.device):
        err = _library().mc_packed_metropolis_half(
            x.data_ptr(), out.data_ptr(), h, width, x.shape[1], parity, prng.as_u32(k0),
            prng.as_u32(k1), prng.counter_word(step, substream), int(origin),
            prng.as_u32(thr3), prng.as_u32(thr4), int(not narrow_launch(h, width, origin)),
            _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"mc_packed_metropolis_half launch failed: CUDA error {err}")
    packed_metropolis_half.launches += 1
    return out


packed_metropolis_half.launches = 0


# -- the batch modes -------------------------------------------------------------

#: the most slots a batch launch takes (the grid's y extent)
MAX_SLOTS = 65535


def _check_state(state: SlotState, slots: int, device: torch.device) -> None:
    if not 1 <= slots <= MAX_SLOTS:
        raise ValueError(f"a batch holds 1..{MAX_SLOTS} slots, got {slots}")
    for name, t in zip(SlotState._fields, state):
        want = (slots, 5) if name == "thr" else (slots,)
        if t.dtype != torch.int32 or tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor of shape {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, the batch on {device}")


#: The plain PyTorch version of K7's batch mode, on any device.
cell_uniforms_batch_plain = prng.cell_uniforms_batch_torch


def cell_uniforms_batch(
    shape: tuple[int, int], state: SlotState, substream: int, *, offset: int = 0,
) -> torch.Tensor:
    """Word 0 of the hash for every cell of each slot's ``[h, w]`` board,
    the draws of sweep ``offset`` of the chunk in ``substream``, under each
    slot's key and counter in ``state``: an int32[S, h, w] tensor of the
    uint32 draws' bit patterns on the state's device, zeros for a frozen
    slot (``rem <= offset``).  Kernel K7's batch mode on a CUDA device, the
    plain version on the CPU."""
    h, w = (int(v) for v in shape)
    device = state.rem.device
    slots = state.rem.shape[0] if state.rem.dim() == 1 else 0
    _check_state(state, slots, device)
    if not 0 <= substream < prng.NSUB:
        raise ValueError(f"substream must be in [0, {prng.NSUB}), got {substream}")
    if offset < 0:
        raise ValueError(f"offset must be >= 0, got {offset}")
    prng.check_block(h * w, 0)
    if device.type == "cpu":
        return cell_uniforms_batch_plain((h, w), state, substream, offset=offset)
    if device.type != "cuda":
        raise ValueError(f"cell_uniforms_batch runs on cuda or cpu tensors, got {device}")
    out = torch.empty((slots, h, w), dtype=torch.int32, device=device)
    if h * w == 0:
        return out
    with torch.cuda.device(device):
        err = _library().mc_cell_uniforms_batch(
            out.data_ptr(), slots, h * w, state.k0.data_ptr(), state.k1.data_ptr(),
            state.counter.data_ptr(), state.rem.data_ptr(), substream, offset, _stream(device),
        )
    if err != 0:
        raise RuntimeError(f"mc_cell_uniforms_batch launch failed: CUDA error {err}")
    cell_uniforms_batch.launches += 1
    return out


cell_uniforms_batch.launches = 0


def packed_metropolis_half_batch_plain(
    x: torch.Tensor, parity: int, state: SlotState, *, width: int, offset: int = 0,
    origin: int = 0, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of K6's batch mode on any device
    (``mc.packed.half_sweep_batch_torch``).  It returns a new tensor and
    ignores ``out``, which it takes so that it and
    :func:`packed_metropolis_half_batch` are interchangeable."""
    return packed.half_sweep_batch_torch(x, parity, state, width=width, offset=offset,
                                         origin=origin)


def packed_metropolis_half_batch(
    x: torch.Tensor, parity: int, state: SlotState, *, width: int, offset: int = 0,
    origin: int = 0, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One checkerboard half-sweep of parity ``parity`` of every live slot of
    the packed batch ``x`` (int32[S, H, ceil(W/32)] words, ``width`` = W, H
    and W even), sweep ``offset`` of the chunk: slot ``s`` at counter
    ``state.counter[s] + offset`` under its key and its table's entries 3
    and 4 where ``offset < state.rem[s]``, and copied through where not;
    each board's cell (0, 0) at flat index ``origin``.

    On a CUDA tensor kernel K6's batch mode writes the result into ``out``
    (a second buffer of ``x``'s shape on its device, allocated when None)
    and returns it; ``x`` is left as it was.  The launch takes the narrow
    instance where :func:`narrow_launch` holds for one board and the wide
    one where it does not.  On a CPU tensor it returns the plain version's
    result."""
    if parity not in (0, 1):
        raise ValueError(f"parity must be 0 or 1, got {parity}")
    if x.dim() != 3:
        raise TypeError(f"x must be int32 packed words [S, H, ceil(W/32)], got {tuple(x.shape)}")
    slots, h = x.shape[0], x.shape[1]
    if h % 2 or width % 2 or h < 2 or width < 2:
        raise ValueError(f"the packed half-sweep needs even dimensions, got {h}x{width}")
    if origin < 0 or offset < 0:
        raise ValueError(f"origin and offset must be >= 0, got {origin} and {offset}")
    _check_words(x[0], width, "x")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _check_state(state, slots, x.device)
    if x.device.type == "cpu":
        return packed_metropolis_half_batch_plain(x, parity, state, width=width, offset=offset,
                                                  origin=origin)
    if x.device.type != "cuda":
        raise ValueError(f"packed_metropolis_half_batch runs on cuda or cpu tensors, got "
                         f"{x.device}")
    if out is None:
        out = torch.empty_like(x)
    if (out.shape != x.shape or out.dtype != x.dtype or out.device != x.device
            or not out.is_contiguous() or out.data_ptr() == x.data_ptr()):
        raise ValueError("out must be a second buffer of x's shape on x's device")
    with torch.cuda.device(x.device):
        err = _library().mc_packed_metropolis_batch(
            x.data_ptr(), out.data_ptr(), slots, h, width, x.shape[2], parity,
            state.k0.data_ptr(), state.k1.data_ptr(), state.counter.data_ptr(),
            state.thr.data_ptr(), state.rem.data_ptr(), offset, int(origin),
            int(not narrow_launch(h, width, origin)), _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"mc_packed_metropolis_batch launch failed: CUDA error {err}")
    packed_metropolis_half_batch.launches += 1
    return out


packed_metropolis_half_batch.launches = 0
