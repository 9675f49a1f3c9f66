"""The driver (from ``tpu_life/runtime/driver.py``'s ``run``/``_run``).

Sequence: resolve the config -> build the backend -> stage the board ->
chunked drive -> gather -> atomic output write -> report
``Total time = <s>``, the reference's contract line.

A run whose height, width and steps all come from flags, with no input
file, stages a seeded random board (``mc.prng.seeded_board``, the board
the JAX driver stages for the same seed); a run that reads its geometry
from the config file still needs its input file.

Not ported yet (ROADMAP.md): multi-process runs, streamed per-shard I/O,
the tuned backend, snapshots and elastic recovery, tracing and metrics
files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from tpu_life_torch.backends.base import drive_runner, get_backend, make_runner
from tpu_life_torch.config import RunConfig
from tpu_life_torch.io.codec import read_board, write_board
from tpu_life_torch.mc.prng import seeded_board
from tpu_life_torch.models.rules import get_rule, validate_rule_geometry
from tpu_life_torch.utils.timing import Timer


@dataclass
class RunResult:
    board: np.ndarray
    steps_run: int
    elapsed_s: float
    backend: str
    rule: str
    route: str  # the executor the runner took (``DeviceRunner.route``), or the backend's name
    seed: int | None = None  # the seed of a seeded board; None when the board came from a file


def _write_atomic(path: Path, board: np.ndarray) -> None:
    """Publish ``board`` at ``path`` only once fully written: a crash
    mid-write never leaves a truncated output.txt."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        write_board(tmp, board)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)  # no-op after a successful replace


def run(cfg: RunConfig) -> RunResult:
    height, width, steps = cfg.resolved_geometry()
    rule = get_rule(cfg.effective_rule())
    validate_rule_geometry(rule, (height, width))

    timer = Timer()  # spans I/O too, like the reference's Wtime bracket
    kwargs = {"device": cfg.device, "bitpack": cfg.bitpack}
    if cfg.block_steps is not None:
        kwargs["block_steps"] = cfg.block_steps
    if cfg.backend == "sharded":
        kwargs.update(num_devices=cfg.num_devices, mesh_shape=cfg.mesh_shape,
                      local_kernel=cfg.local_kernel)
    backend = get_backend(cfg.backend, **kwargs)

    seeded = (
        cfg.height is not None
        and cfg.width is not None
        and cfg.steps is not None
        and not Path(cfg.input_file).exists()
    )
    if seeded:
        board = seeded_board(height, width, states=rule.states, seed=cfg.seed)
    else:
        board = read_board(cfg.input_file, height, width)
        max_state = int(board.max(initial=0))
        if max_state >= rule.states:
            raise ValueError(
                f"board contains state {max_state} but rule {rule.name!r} has "
                f"only {rule.states} states (0..{rule.states - 1})"
            )
    runner = make_runner(backend, board, rule)
    drive_runner(runner, steps, chunk_steps=cfg.sync_every)
    board = runner.fetch()
    if cfg.output_file:
        _write_atomic(Path(cfg.output_file), board)

    elapsed = timer.elapsed
    print(f"Total time = {elapsed}")
    return RunResult(
        board=board,
        steps_run=steps,
        elapsed_s=elapsed,
        backend=backend.name,
        rule=rule.name,
        route=getattr(runner, "route", backend.name),
        seed=cfg.seed if seeded else None,
    )
