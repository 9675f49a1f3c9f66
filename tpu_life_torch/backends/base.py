"""The Backend interface and registry (from ``tpu_life/backends/base.py``).

A backend advances a board ``steps`` steps; all backends are bit-identical
on the same (board, rule, steps) and differ only in where the work runs:

- ``numpy``  the pure-NumPy truth executor, on the host
- ``torch``  plain PyTorch ops (bit-sliced where the rule allows, else the
             int8 stencil, its counts by shift-adds or banded matmuls;
             the float Lenia step for continuous rules), on an explicit
             device
- ``cuda``   the hand-written kernels on the card, and plain PyTorch ops
             there for the rules no kernel counts (the plain versions
             when the caller asks for the CPU); no float path
- ``sharded`` the board in row stripes over a mesh of devices, a halo
             exchange and one step of every shard per block (kernel K3
             per shard for packed rules)

Continuous rules (``models.lenia``) run on ``torch``, ``numpy`` and
``sharded`` only, on float32 boards; ``auto`` sends them to ``torch``.  The
stochastic rule specs are refused when parsed
(``models.rules.NotPortedError``).
"""

from __future__ import annotations

from typing import Callable, Protocol

import numpy as np
import torch

from tpu_life_torch.models.rules import Rule

# callback(step_index, get_board) where get_board() lazily materializes the
# current board as np.int8
ChunkCallback = Callable[[int, Callable[[], np.ndarray]], None]


class CudaUnavailableError(RuntimeError):
    """A run asked for the card (``auto``/``cuda``/``torch`` on the default
    device) on a machine where ``torch.cuda.is_available()`` is false."""


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device a backend runs on: the card unless the caller asks for
    the CPU.  Never falls back from the card to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise CudaUnavailableError(
                "no CUDA device is available; pass --device cpu to run the "
                "plain PyTorch version on the CPU, or --backend numpy"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


class Runner(Protocol):
    """Device-resident run handle: state stays on the device between
    advances.  ``advance`` queues work with no host round-trip; ``sync``
    forces completion; ``fetch`` materializes the board on the host."""

    def advance(self, steps: int) -> None: ...

    def sync(self) -> None: ...

    def fetch(self) -> np.ndarray: ...

    def snapshot(self) -> Callable[[], np.ndarray]:
        """A ``get_board`` thunk bound to the *current* state."""
        ...

    def live_count(self) -> int:
        """Exact count of live (state 1) cells."""
        ...


class HostRunner:
    """Runner for host backends (numpy): state is a host array and
    ``advance`` calls ``backend.run`` on it."""

    def __init__(self, backend: "Backend", board: np.ndarray, rule: Rule):
        self.backend = backend
        self.rule = rule
        if getattr(rule, "continuous", False):
            from tpu_life_torch.models.lenia import validate_board

            self.board = validate_board(board, rule)
        else:
            self.board = np.asarray(board, np.int8)

    def advance(self, steps: int) -> None:
        self.board = self.backend.run(self.board, self.rule, steps)

    def sync(self) -> None:
        pass

    def fetch(self) -> np.ndarray:
        return self.board

    def snapshot(self) -> Callable[[], np.ndarray]:
        return lambda board=self.board: board

    def live_count(self) -> int:
        # a float board's live cells are those at or above one half
        live = self.board >= 0.5 if self.board.dtype == np.float32 else self.board == 1
        return int(np.count_nonzero(live))


class Backend(Protocol):
    name: str

    def run(
        self,
        board: np.ndarray,
        rule: Rule,
        steps: int,
        *,
        chunk_steps: int = 0,
        callback: ChunkCallback | None = None,
    ) -> np.ndarray: ...


def make_runner(backend: "Backend", board: np.ndarray, rule: Rule) -> Runner:
    """Stage ``board`` on the backend's device and return a Runner:
    ``backend.prepare`` where the backend has device state, else a
    ``HostRunner``.  Each backend routes continuous rules itself; the
    ``cuda`` backend raises for them rather than cast the board to int8."""
    prep = getattr(backend, "prepare", None)
    if prep is not None:
        return prep(board, rule)
    return HostRunner(backend, board, rule)


def drive_runner(
    r: Runner,
    steps: int,
    *,
    chunk_steps: int = 0,
    callback: ChunkCallback | None = None,
) -> None:
    """The chunked epoch loop over a Runner (no final fetch)."""
    done = 0
    for n in chunk_sizes(steps, chunk_steps):
        r.advance(n)
        done += n
        if callback is not None:
            callback(done, r.snapshot())
    r.sync()


def run_with_runner(
    backend: "Backend",
    board: np.ndarray,
    rule: Rule,
    steps: int,
    *,
    chunk_steps: int = 0,
    callback: ChunkCallback | None = None,
) -> np.ndarray:
    """Chunked ``run`` over a fresh Runner, returning the final board."""
    r = make_runner(backend, board, rule)
    drive_runner(r, steps, chunk_steps=chunk_steps, callback=callback)
    return r.fetch()


def n_chips(backend: "Backend") -> int:
    """The distinct devices a backend's mesh spans (1 without a mesh): a
    mesh may put several shards on one card, and those are one chip."""
    mesh = getattr(backend, "mesh", None)
    return len(set(mesh.devices)) if mesh is not None else 1


def measure_throughput(
    backend: "Backend",
    board: np.ndarray,
    rule: Rule,
    steps: int,
    base_steps: int,
    repeats: int = 3,
) -> tuple[float, int]:
    """(cells/s/chip, n_chips) of a backend via delta timing.

    The measurement core of the CLI's ``bench`` subcommand: stage the
    board, difference two runs of the Runner
    (``utils.timing.delta_seconds_per_step``), and divide by the distinct
    devices the backend spans (:func:`n_chips`).
    """
    from tpu_life_torch.utils.timing import delta_seconds_per_step

    runner = make_runner(backend, board, rule)
    per_step = delta_seconds_per_step(runner, steps, base_steps, repeats=repeats)
    chips = n_chips(backend)
    h, w = board.shape
    return h * w / per_step / chips, chips


def measure_parity_interleaved(
    composed: "Backend",
    single: "Backend",
    board: np.ndarray,
    rule: Rule,
    steps: int,
    base_steps: int,
    repeats: int = 6,
) -> dict:
    """The parity methodology of ``tpu_life/backends/base.py``:
    back-to-back (composed, single) delta pairs cancel the device's drift
    between windows; the reported ratio is the median per-pair
    composed-per-chip over single-chip throughput.  Returns the
    ``parity_*`` record fields (``parity_ratio`` None when every pair was
    timer noise).
    """
    import statistics

    from tpu_life_torch.utils.timing import paired_delta_seconds_per_step

    r_comp = make_runner(composed, board, rule)
    r_single = make_runner(single, board, rule)
    pairs = paired_delta_seconds_per_step(
        r_comp, r_single, steps, base_steps, repeats=repeats
    )
    if not pairs:
        return {"parity_ratio": None, "parity_ok": False}
    chips = n_chips(composed)
    ratios = [d_single / (d_comp * chips) for d_comp, d_single in pairs]
    comp_deltas = [d for d, _ in pairs]
    h, w = board.shape
    ratio = statistics.median(ratios)
    return {
        "parity_single_chip": h * w / min(d for _, d in pairs),
        "parity_ratio": ratio,
        "parity_pairs": len(pairs),
        "parity_window_spread": max(comp_deltas) / min(comp_deltas),
        "parity_ok": ratio >= 0.8,
        "parity_in_band": 0.95 <= ratio <= 1.05,
    }


BACKENDS: dict[str, Callable[..., Backend]] = {}


def register_backend(name: str):
    def deco(factory):
        BACKENDS[name] = factory
        return factory

    return deco


def get_backend(name: str, *, rule: Rule | None = None, **kwargs) -> Backend:
    """Instantiate a backend by name.  ``auto`` is the ``cuda`` backend, or
    ``torch`` when the ``rule`` hint is continuous: the kernels have no
    float path.

    ``auto`` never picks the CPU by itself: without a card it raises
    :class:`CudaUnavailableError` unless the caller passes ``device="cpu"``.
    """
    # import for registration side effects
    from tpu_life_torch.backends import (  # noqa: F401
        cuda_backend,
        numpy_backend,
        sharded_backend,
        torch_backend,
    )

    if name == "auto":
        name = "torch" if getattr(rule, "continuous", False) else "cuda"
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; available: {sorted(BACKENDS)}")
    return BACKENDS[name](**kwargs)


def chunk_sizes(steps: int, chunk_steps: int) -> list[int]:
    """Split ``steps`` into host-sync chunks (0 or >= steps -> one chunk)."""
    if steps <= 0:
        return []
    if chunk_steps <= 0 or chunk_steps >= steps:
        return [steps]
    out = [chunk_steps] * (steps // chunk_steps)
    if steps % chunk_steps:
        out.append(steps % chunk_steps)
    return out
