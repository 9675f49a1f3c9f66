"""The driver (from ``tpu_life/runtime/driver.py``'s ``run``/``_run``).

Sequence: resolve the config -> build the backend -> stage the board (or
resume) -> chunked drive with optional snapshots and metrics -> gather ->
atomic output write -> report ``Total time = <s>``, the reference's
contract line.

A run whose height, width and steps all come from flags, with no input
file, stages a seeded random board (``mc.prng.seeded_board``, the board
the JAX driver stages for the same seed; a continuous rule's float twin,
``models.lenia.seeded_board``); a run that reads its geometry from the
config file still needs its input file.  Float32 boards (the continuous
tier) are read, checked (``lenia.validate_board``), snapshotted and
written by the same codec, in the JAX package's bytes.

Telemetry: every invocation generates one ``run_id`` stamped into the
metrics JSONL records and the ``--trace-events`` Chrome trace, whose spans
bracket each host phase: ``config-resolve``, ``backend-build``, ``stage``,
``drive`` with one ``chunk`` event per host sync, ``snapshot-write``,
``recovery-rewind``, ``gather`` and ``output-write``, inside ``run``.
With tracing, metrics, snapshots and ``--verbose`` all off the chunk
callback is None and the run is the plain chunked drive.

Snapshots (``--snapshot-every``) are written at the first host sync at or
past each multiple, anchored to absolute steps across ``--resume`` and
restarts; they are contract board files with the JAX package's names and
sidecars, so either package resumes the other's.  Elastic recovery
(``--max-restarts``, ``runtime/recovery.py``) rebuilds the backend after a
recoverable failure and resumes from the newest snapshot this run wrote.

Not ported yet (ROADMAP.md): multi-process runs, streamed per-shard I/O
(``--stream-io``, streamed snapshots), the tuned backend and the
stochastic rule tier.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from tpu_life_torch import obs
from tpu_life_torch.backends.base import drive_runner, get_backend, make_runner
from tpu_life_torch.config import RunConfig
from tpu_life_torch.io.codec import read_board, write_board
from tpu_life_torch.mc.prng import seeded_board
from tpu_life_torch.models import lenia
from tpu_life_torch.models.rules import get_rule, validate_rule_geometry
from tpu_life_torch.runtime import checkpoint as ckpt
from tpu_life_torch.runtime import recovery
from tpu_life_torch.runtime.metrics import MetricsRecorder, configure_logging, dump_board, log
from tpu_life_torch.runtime.profiling import maybe_profile
from tpu_life_torch.utils.timing import Timer


@dataclass
class RunResult:
    board: np.ndarray
    steps_run: int  # steps this run advanced (past the resume point)
    elapsed_s: float
    backend: str
    rule: str
    route: str  # the executor the runner took (``DeviceRunner.route``), or the backend's name
    seed: int | None = None  # the seed of a seeded board; None when the board came from a file
    metrics: list[dict] = field(default_factory=list)
    restarts: int = 0  # recoveries taken by the elastic-recovery loop
    run_id: str = ""  # correlation id shared by metrics/trace artifacts


def run(cfg: RunConfig) -> RunResult:
    configure_logging(cfg.verbose)
    run_id = obs.new_run_id()
    tracer = obs.start_tracing(cfg.trace_events, run_id=run_id) if cfg.trace_events else None
    try:
        with obs.span("run", run_id=run_id, backend=cfg.backend, rule=cfg.rule):
            return _run(cfg, run_id)
    finally:
        if tracer is not None:
            obs.stop_tracing(tracer)
            log.info("trace events -> %s (run_id=%s)", tracer.path, run_id)


def _run(cfg: RunConfig, run_id: str) -> RunResult:
    with obs.span("config-resolve"):
        height, width, steps = cfg.resolved_geometry()
        rule = get_rule(cfg.effective_rule())
        validate_rule_geometry(rule, (height, width))

    timer = Timer()  # spans I/O too, like the reference's Wtime bracket

    backend_kwargs = {"device": cfg.device, "bitpack": cfg.bitpack, "stencil": cfg.stencil}
    if cfg.block_steps is not None:
        backend_kwargs["block_steps"] = cfg.block_steps
    if cfg.backend == "sharded":
        backend_kwargs.update(num_devices=cfg.num_devices, mesh_shape=cfg.mesh_shape,
                              local_kernel=cfg.local_kernel)
    registry = obs.MetricsRegistry()
    builds = registry.counter(
        "run_backend_builds_total",
        "backend (re)builds: the first and one a restart",
        labels=("backend",),
    )
    with obs.span("backend-build", backend=cfg.backend):
        # the rule hint sends `auto` to the float path for continuous rules
        backend = get_backend(cfg.backend, rule=rule, **backend_kwargs)
    builds.labels(backend=backend.name).inc()

    # Board source: a contract-format file (+ completed steps when resuming),
    # or None for the seeded board of a run whose geometry comes from flags
    start_step = 0
    input_path = cfg.input_file
    if cfg.resume:
        input_path, start_step, height, width = ckpt.resolve_resume(cfg.resume, height, width)
        log.info("resuming from %s at step %d", input_path, start_step)
    elif (
        cfg.height is not None
        and cfg.width is not None
        and cfg.steps is not None
        and not Path(input_path).exists()
    ):
        log.info(
            "input file %r absent; using a seeded random board (%dx%d, "
            "density 0.5, seed %d)",
            input_path, height, width, cfg.seed,
        )
        input_path = None

    origin = (input_path, start_step)  # restart target when no snapshot exists
    fault_fired: list[bool] = []

    def build_runner(source, start):
        """The runner staged from a contract-format file (``source=None``:
        the seeded board).  Called once up front and again after each
        elastic-recovery restart, with the rebuilt ``backend``."""
        with obs.span("stage", resume_step=start):
            if source is None:
                if rule.continuous:
                    b = lenia.seeded_board(height, width, seed=cfg.seed)
                else:
                    b = seeded_board(height, width, states=rule.states, seed=cfg.seed)
            else:
                b = read_board(source, height, width)
                if rule.continuous:
                    b = lenia.validate_board(b, rule)
                else:
                    max_state = int(b.max(initial=0))
                    if max_state >= rule.states:
                        raise ValueError(
                            f"board contains state {max_state} but rule {rule.name!r} has "
                            f"only {rule.states} states (0..{rule.states - 1})"
                        )
            r = make_runner(backend, b, rule)
            if cfg.fault_at > 0:
                r = recovery.FaultingRunner(r, start, cfg.fault_at, fault_fired, cfg.fault_count)
        return r

    remaining = max(0, steps - start_step)
    recorder = MetricsRecorder(
        height * width,
        cfg.metrics or cfg.verbose or bool(cfg.metrics_file),
        start_step=start_step,
        # a raw append log: recovery rewinds may repeat steps there
        # (RunResult.metrics is the deduplicated record)
        sink=cfg.metrics_file,
        run_id=run_id,
        registry=registry,
        labels={"backend": backend.name, "rule": rule.name},
    )

    chunk = cfg.sync_every
    if cfg.snapshot_every > 0:
        chunk = cfg.snapshot_every if chunk <= 0 else min(chunk, cfg.snapshot_every)

    # crossing detection: snapshot at the first sync point at-or-past each
    # snapshot_every multiple, so sync_every and snapshot_every need not
    # divide each other.  `last_snap` lives in ABSOLUTE step space and
    # restarts rewind it to the resume step, so the cadence stays anchored
    # to global snapshot_every multiples across --resume and recovery.
    # `written` records the absolute steps of snapshots THIS run wrote,
    # the only snapshots recovery trusts as restart sources.
    state = {
        "start": start_step,
        "last_snap": start_step,
        "written": [],
        "chunk_t0": 0.0,  # trace clock at the last chunk boundary
    }

    def on_chunk(done_local: int, get_board) -> None:
        done = state["start"] + done_local
        # the chunk's trace record is a complete (ph "X") event spanning
        # since the previous boundary, emitted after the fact because the
        # chunked loop owns the advance, not this callback
        t_end = obs.now()
        obs.complete("chunk", state["chunk_t0"], t_end, step=done)
        state["chunk_t0"] = t_end
        if recorder.enabled:
            # the live count is reduced on the device: one scalar a shard
            # crosses to the host, never the board
            recorder.record_chunk(done, timer.elapsed, runner.live_count())
        # a board gather happens only for the --verbose small-board dump
        board_np = get_board() if cfg.verbose else None
        if (
            cfg.snapshot_every > 0
            and done // cfg.snapshot_every > state["last_snap"] // cfg.snapshot_every
        ):
            state["last_snap"] = done
            with obs.span("snapshot-write", step=done):
                p = ckpt.save_snapshot(
                    cfg.snapshot_dir,
                    done,
                    board_np if board_np is not None else get_board(),
                    rule=rule.name,
                )
                state["written"].append(done)
                log.info("snapshot step=%d -> %s", done, p)
                if cfg.keep_snapshots > 0:
                    # retention manages only THIS run's snapshots, and the
                    # kept list replaces state["written"] so recovery never
                    # targets a pruned file
                    state["written"] = ckpt.prune_snapshots(
                        cfg.snapshot_dir, cfg.keep_snapshots, state["written"]
                    )
        if cfg.verbose and board_np is not None:
            log.debug("board at step %d:\n%s", done, dump_board(board_np))

    callback = (
        on_chunk
        if (
            cfg.snapshot_every > 0
            or cfg.metrics
            or cfg.metrics_file
            or cfg.verbose
            or cfg.trace_events  # chunk trace events need the boundary callback too
        )
        else None
    )

    # The drive, wrapped in the elastic-recovery loop: a recoverable
    # failure (a RuntimeError from a step, or the --fault-at drill) rebuilds
    # the backend and resumes from the newest snapshot, up to
    # cfg.max_restarts times.  ALL board staging, the first included,
    # happens INSIDE the try, so a device failing while the runner is
    # built consumes a restart instead of escaping with budget remaining;
    # and so does the first kernel build, which is why recovery.FATAL
    # (no card, a kernel that does not build) is raised at once.
    restarts = 0
    pending: tuple | None = (input_path, start_step)
    first_build = True
    runner = board = None
    try:
        with maybe_profile(cfg.profile):
            while True:
                try:
                    if pending is not None:
                        source, resume_step = pending
                        rewind_span = (
                            nullcontext()
                            if first_build
                            else obs.span("recovery-rewind", step=resume_step, restart=restarts)
                        )
                        with rewind_span:
                            if not first_build:
                                # a failure poisoned the old backend: start fresh
                                backend = get_backend(cfg.backend, rule=rule, **backend_kwargs)
                                builds.labels(backend=backend.name).inc()
                            first_build = False
                            state["start"] = resume_step
                            state["last_snap"] = resume_step
                            # drop metric records the rewind is about to re-earn
                            recorder.records[:] = [
                                r for r in recorder.records if r["step"] <= resume_step
                            ]
                            runner = build_runner(source, resume_step)
                        pending = None
                    state["chunk_t0"] = obs.now()
                    with obs.span("drive", steps=max(0, steps - state["start"])):
                        drive_runner(
                            runner,
                            max(0, steps - state["start"]),
                            chunk_steps=chunk,
                            callback=callback,
                        )
                    # the final gather is as killable as any step, so it sits
                    # inside the recovery scope too
                    with obs.span("gather"):
                        board = runner.fetch()
                    break
                except recovery.RECOVERABLE as e:
                    if isinstance(e, recovery.FATAL) or restarts >= cfg.max_restarts:
                        raise
                    restarts += 1
                    if state["written"]:
                        # only snapshots THIS run wrote are trusted restart
                        # sources: a stale snapshots/ dir left by an earlier,
                        # unrelated run cannot hijack the resume
                        snap = max(state["written"])
                        pending = (ckpt.snapshot_path(cfg.snapshot_dir, snap), snap)
                    else:
                        pending = origin
                    log.warning(
                        "recoverable failure (%s: %s); restart %d/%d from %s at step %d",
                        type(e).__name__, e, restarts, cfg.max_restarts, pending[0], pending[1],
                    )
                    if cfg.restart_wait_s > 0:
                        time.sleep(cfg.restart_wait_s)
        if cfg.output_file:
            with obs.span("output-write", streamed=False):
                out_p = Path(cfg.output_file)
                out_p.parent.mkdir(parents=True, exist_ok=True)
                # atomic: a crash mid-write never leaves a truncated output.txt,
                # itself a resume source (output format == input format)
                with ckpt.atomic_publish(out_p) as tmp:
                    write_board(tmp, board)

        elapsed = timer.elapsed
    finally:
        # flushes the registry snapshot (build counts, chunk-duration
        # histogram) into the sink and releases its handle, failed run or not
        recorder.close()
    print(f"Total time = {elapsed}")
    return RunResult(
        board=board,
        steps_run=remaining,
        elapsed_s=elapsed,
        backend=backend.name,
        rule=rule.name,
        route=getattr(recovery.unwrap(runner), "route", backend.name),
        seed=cfg.seed if origin[0] is None else None,
        metrics=recorder.records,
        restarts=restarts,
        run_id=run_id,
    )
