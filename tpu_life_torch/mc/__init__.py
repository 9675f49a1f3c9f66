"""The stochastic tier (from ``tpu_life/mc/__init__.py``).

Metropolis sweeps of the 2-D Ising model and noisy Life, whose draws come
from a counter-based PRNG keyed by ``(seed, step, cell, substream)``, so
any trajectory is bit-reproducible from its seed whatever the chunking,
executor or resume point:

- :mod:`tpu_life_torch.mc.prng` — Threefry-2x32 on numpy and its torch
  twin (the plain version of kernel K7);
- :mod:`tpu_life_torch.mc.ising` — the checkerboard Metropolis sweep, a
  host-computed uint32[5] acceptance table per temperature;
- :mod:`tpu_life_torch.mc.noisy` — any 2-state rule composed with
  per-cell flips;
- :mod:`tpu_life_torch.mc.packed` — the bitplane-packed sweep, 32 spins a
  word (its torch half-sweep is the plain version of kernel K6);
- :mod:`tpu_life_torch.mc.engine` — the Runners behind ``run --rule
  ising`` and ``run --rule noisy:<p>/<base>``, and the serving tier's
  stochastic engines (``submit``, ``serve``, ``sweep``).

The executors implementing the key schedule are ``numpy`` (the oracle),
``torch`` (plain ops, the counterpart of the JAX package's ``jax``
backend) and ``cuda`` (kernels K6 and K7, and K2 for noisy bases it
steps).  ``sharded`` stays a typed rejection, as in the JAX package.
The dispatchers below (``step_np`` / ``run_np`` / ``make_step_fn`` /
``make_batch_step_fn``) are the seam the backends, runners, engines and
tests share.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_life_torch.models.rules import IsingRule, NoisyRule, Rule
from tpu_life_torch.mc import prng
from tpu_life_torch.mc.prng import key_halves, seeded_board
from tpu_life_torch.mc import ising, noisy


class StochasticBackendError(ValueError):
    """A stochastic rule asked of an executor without the counter-based key
    schedule; ``run`` exits 2 on it, as on the sharded backend's other
    refusals."""


def validate_params(rule: Rule, temperature: float | None) -> None:
    """Typed errors for the (rule, temperature) pairing — shared by the
    driver and ``bench --mc`` so every front speaks the same contract."""
    if isinstance(rule, IsingRule):
        if temperature is None:
            raise ValueError(
                f"rule {rule.name!r} is a Metropolis sampler and needs a "
                f"temperature (e.g. --temperature 2.27)"
            )
        t = float(temperature)
        if not np.isfinite(t) or t < 0.0:
            raise ValueError(
                f"temperature must be a finite number >= 0, got {temperature!r}"
            )
    elif temperature is not None:
        raise ValueError(
            f"temperature only applies to the 'ising' rule; rule "
            f"{rule.name!r} does not take one"
        )


#: Executors implementing the counter-based key schedule: the driver's
#: pre-check and the runner factory both consult it.
SUPPORTED_BACKENDS = ("numpy", "torch", "cuda")


def require_key_schedule(rule: Rule, backend_name: str) -> None:
    """The hard gate: ``backend_name`` must implement the key schedule.
    A silent fallback would produce a different (and irreproducible)
    trajectory, which is worse than an error."""
    if backend_name not in SUPPORTED_BACKENDS:
        raise StochasticBackendError(
            f"stochastic rule {rule.name!r} needs the cuda, torch or numpy "
            f"backend (the counter-based per-cell key schedule is not "
            f"implemented for {backend_name!r}); a silent deterministic "
            f"fallback would not be the rule you asked for"
        )


def ensure_backend_supported(rule: Rule, backend_name: str) -> None:
    """Driver-facing form of :func:`require_key_schedule`: ``auto`` is
    allowed through (``get_backend`` resolves it to ``cuda``)."""
    if getattr(rule, "stochastic", False) and backend_name != "auto":
        require_key_schedule(rule, backend_name)


def packed_supports(rule: Rule) -> bool:
    """True when the bitplane-packed Metropolis path (``mc.packed``) covers
    ``rule``: the ising family."""
    return isinstance(rule, IsingRule)


def wide_counter_capable(rule: Rule, backend_name: str, *, bitpack: bool = True) -> bool:
    """Whether this (rule, backend, bitpack) admission runs on an executor
    implementing the two-word (wide) PRNG cell index.

    Only the packed path carries the wide schedule; the int8 roll path is
    pinned to the narrow one-word index, so over-2^32-cell boards on it
    are a typed rejection (``validate_board_shape``), never a silent
    counter wraparound.  ``auto`` resolves stochastic rules to ``cuda``,
    which like ``torch`` defaults to the packed path; explicit numpy stays
    the roll ground truth.
    """
    return bitpack and packed_supports(rule) and backend_name in ("auto", "torch", "cuda")


def validate_board_shape(
    rule: Rule, shape: tuple[int, int], *, wide_counter: bool = False
) -> None:
    """Typed rejection for lattices the rule cannot run correctly.

    The ising checkerboard 2-coloring is only a valid independent-set
    decomposition on the torus when BOTH dimensions are even: with an
    odd dimension, wrap-seam neighbors share a parity, so the two
    half-updates would step coupled spins simultaneously — no longer
    Metropolis.

    Board AREA is validated against the PRNG counter width for every
    stochastic rule: past ``prng.MAX_NARROW_CELLS`` the one-word cell
    index would wrap mod 2^32 and silently reuse draws — a typed
    rejection on the narrow (roll) path, legal on executors carrying the
    two-word wide index (``wide_counter=True``: the packed path).
    """
    if not getattr(rule, "stochastic", False):
        return
    h, w = int(shape[0]), int(shape[1])
    if isinstance(rule, IsingRule) and (h % 2 or w % 2):
        raise ValueError(
            f"rule {rule.name!r} needs even lattice dimensions (the "
            f"torus checkerboard 2-coloring breaks across the wrap "
            f"seam on odd sizes), got {h}x{w}"
        )
    if h * w > prng.MAX_NARROW_CELLS and not wide_counter:
        raise ValueError(
            f"board has {h * w} cells, past the one-word PRNG cell index "
            f"({prng.MAX_NARROW_CELLS} cells): the narrow counter would "
            f"wrap and reuse draws.  Only the packed executors (wide "
            f"two-word cell index) carry the schedule for boards this "
            f"size, and staging one additionally needs shard-wise I/O "
            f"(cell_uniforms(origin=...) blocks; see docs/STOCHASTIC.md "
            f"limits) — or shrink the lattice"
        )


def make_step_fn(xp, rule: Rule, *, uniforms=None, base=None):
    """One stochastic step as ``fn(board, k0, k1, step, thresholds)``.

    ``xp`` is ``numpy`` (the oracle, on int8 arrays) or ``torch`` (int8
    tensors on any device; ``step`` a Python int).  ``thresholds`` is the
    ising uint32[5] acceptance table; noisy rules ignore it (their flip
    probability is frozen in the rule itself).  The torch form takes its
    draws from ``uniforms`` (``prng.cell_uniforms_torch`` when None, or
    kernel K7's ``kernels.mc_threefry.cell_uniforms``) and a noisy rule's
    deterministic step from ``base`` (``ops.stencil.make_step`` when None,
    or kernel K2).
    """
    if isinstance(rule, IsingRule):
        def step(board, k0, k1, step_idx, thresholds):
            return ising.sweep(xp, board, k0, k1, step_idx, thresholds, uniforms=uniforms)

        return step
    if isinstance(rule, NoisyRule):
        inner = noisy.make_noisy_step(xp, rule, uniforms=uniforms, base=base)

        def step(board, k0, k1, step_idx, thresholds=None):  # noqa: ARG001
            return inner(board, k0, k1, step_idx)

        return step
    raise ValueError(f"rule {rule.name!r} is not stochastic")


def make_batch_step_fn(rule: Rule, *, uniforms=None, base=None):
    """One stochastic step of every live slot of a serving batch, as
    ``fn(boards, state, offset)``: the port's form of the JAX package's
    ``jax.vmap(make_step_fn(jnp, rule))`` under its chunk's freeze mask.

    ``boards`` are int8 ``[S, h, w]`` on any device, ``state`` the slots'
    ``prng.SlotState``; at sweep ``offset`` of the chunk a slot whose budget
    exceeds ``offset`` steps at counter ``state.counter + offset`` under its
    key and table, and any other keeps its board.  ``uniforms`` is the
    batch draw ``fn(shape, state, substream, offset=)`` (K7's batch mode,
    ``kernels.mc_threefry.cell_uniforms_batch``; its plain version when
    None) and ``base`` a noisy rule's deterministic step over the batch
    (``ops.stencil.make_step`` when None).
    """
    if isinstance(rule, IsingRule):
        def stepped(boards, state, offset):
            return ising.sweep_batch(boards, state, offset, uniforms=uniforms)
    elif isinstance(rule, NoisyRule):
        stepped = noisy.make_noisy_batch_step(rule, uniforms=uniforms, base=base)
    else:
        raise ValueError(f"rule {rule.name!r} is not stochastic")

    def step(boards, state, offset):
        return torch.where(state.live(offset), stepped(boards, state, offset), boards)

    return step


def step_np(
    rule: Rule,
    board: np.ndarray,
    seed: int,
    step: int,
    *,
    temperature: float | None = None,
) -> np.ndarray:
    """One ground-truth NumPy step at absolute step index ``step``."""
    k0, k1 = key_halves(seed)
    thr = (
        ising.acceptance_thresholds(temperature)
        if isinstance(rule, IsingRule)
        else None
    )
    return make_step_fn(np, rule)(board, k0, k1, np.uint32(step), thr)


def run_np(
    rule: Rule,
    board: np.ndarray,
    seed: int,
    steps: int,
    *,
    temperature: float | None = None,
    start_step: int = 0,
) -> np.ndarray:
    """``steps`` ground-truth NumPy steps from absolute ``start_step`` —
    the oracle every other executor is pinned bit-identical against."""
    validate_params(rule, temperature)
    k0, k1 = key_halves(seed)
    thr = (
        ising.acceptance_thresholds(temperature)
        if isinstance(rule, IsingRule)
        else None
    )
    fn = make_step_fn(np, rule)
    board = np.asarray(board, np.int8)
    for i in range(steps):
        board = fn(board, k0, k1, np.uint32(start_step + i), thr)
    return board


__all__ = [
    "SUPPORTED_BACKENDS",
    "IsingRule",
    "NoisyRule",
    "StochasticBackendError",
    "ensure_backend_supported",
    "packed_supports",
    "require_key_schedule",
    "validate_board_shape",
    "wide_counter_capable",
    "ising",
    "key_halves",
    "make_batch_step_fn",
    "make_step_fn",
    "noisy",
    "prng",
    "run_np",
    "seeded_board",
    "step_np",
    "validate_params",
]
