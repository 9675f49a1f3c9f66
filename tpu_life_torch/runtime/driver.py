"""The driver (from ``tpu_life/runtime/driver.py``'s ``run``/``_run``).

Sequence: resolve the config -> build the backend -> stage the board (or
resume) -> chunked drive with optional snapshots and metrics -> gather ->
atomic output write -> report ``Total time = <s>``, the reference's
contract line.

A run whose height, width and steps all come from flags, with no input
file, stages a seeded random board (``mc.prng.seeded_board``, the board
the JAX driver stages for the same seed, drawn on the card by kernel K7
when the run is there; a continuous rule's float twin,
``models.lenia.seeded_board``); a run that reads its geometry from the
config file still needs its input file.

Stochastic rules (``ising`` with ``--temperature``, ``noisy:<p>/<base>``;
``tpu_life_torch.mc``) are gated before any backend is built, as the JAX
driver gates them: an executor without the counter-based key schedule
(``sharded``) is refused, the (rule, temperature) pairing validated, and
the board's shape checked against the checkerboard and the PRNG counter's
width.  Their Runners take the seed, the temperature and the absolute
start step, so snapshots, ``--resume`` and elastic recovery re-enter the
stream at the right counter; ``RunResult`` stamps the seed and the
temperature.  Float32 boards (the continuous
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

Streamed I/O (``--stream-io``, the JAX driver's ``stream`` branches): the
``sharded`` backend stages the board from the input file shard by shard
(``prepare_from_file``, a resume too), and writes snapshots and the output
back per shard (``write_runner_to_file``), so the board is never whole on
one host and ``RunResult.board`` is None; live counts still come from the
per-shard reduction.  It is on for boards of ``_STREAM_AUTO_CELLS`` cells
and more whose result goes to a file, unless ``stream_io`` says otherwise.

Several processes (``parallel.mesh.init_distributed``, joined from the
environment before any device is touched): the trace file, the metrics
sink, snapshot retention and sidecars, the whole-board output and the
``Total time`` line belong to the lead process (rank 0), while every
process writes its own shards of a streamed output or snapshot.  Elastic
recovery is process-local, so it is off in such a job: relaunch the whole
job with ``--resume``.

``backend="tuned"`` resolves the backend and its knobs through the
autotuner (``tpu_life_torch.autotune``) in an ``autotune-resolve`` span
(an ``autotune-pick`` event in it names the pick and its source), before
the mesh-shape check: a cache hit, else the cost model, or under
``tune_mode="measure"`` the measured search, whose winner is persisted.
Explicit ``block_steps``, ``local_kernel``, ``bitpack=False`` and
``stencil`` beat the cache, and the tuned ``sync_every`` applies when no
chunk is set.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from tpu_life_torch import mc, obs
from tpu_life_torch.backends.base import drive_runner, get_backend, make_runner
from tpu_life_torch.config import RunConfig
from tpu_life_torch.io.codec import read_board, write_board
from tpu_life_torch.mc.prng import seeded_board
from tpu_life_torch.models import lenia
from tpu_life_torch.models.rules import get_rule, validate_rule_geometry
from tpu_life_torch.parallel import mesh
from tpu_life_torch.parallel.mesh import init_distributed
from tpu_life_torch.runtime import checkpoint as ckpt
from tpu_life_torch.runtime import recovery
from tpu_life_torch.runtime.metrics import MetricsRecorder, configure_logging, dump_board, log
from tpu_life_torch.runtime.profiling import maybe_profile
from tpu_life_torch.utils.timing import Timer

# auto-streaming threshold: boards of at least this many cells (16384^2)
# skip the host board when the backend loads and stores per shard
_STREAM_AUTO_CELLS = 1 << 28


@dataclass
class RunResult:
    board: np.ndarray | None  # None on streamed runs (never whole on one host)
    steps_run: int  # steps this run advanced (past the resume point)
    elapsed_s: float
    backend: str
    rule: str
    route: str  # the executor the runner took (``DeviceRunner.route``), or the backend's name
    # the counter-based PRNG seed: stamped for stochastic rules and for
    # seeded-board staging, so the record replays the run; None when the
    # run consumed no seed
    seed: int | None = None
    temperature: float | None = None  # the ising scalar (None elsewhere)
    metrics: list[dict] = field(default_factory=list)
    restarts: int = 0  # recoveries taken by the elastic-recovery loop
    run_id: str = ""  # correlation id shared by metrics/trace artifacts


def _staging_device(backend):
    """The card a seeded board is drawn on: the backend's device, or its
    mesh's first, when that is a CUDA device; None (numpy) otherwise."""
    grid = getattr(backend, "mesh", None)
    device = grid.devices[0] if grid is not None else getattr(backend, "device", None)
    return device if device is not None and device.type == "cuda" else None


def _single_process() -> bool:
    return mesh.process_count() == 1


def _is_lead_process() -> bool:
    """True on the process that owns single-writer side effects (whole-board
    output, the ``Total time`` report): the reference's rank-0 gating
    (Parallel_Life_MPI.cpp:234-236).  Streamed per-shard writes are not
    gated on it: like ``MPI_File_write_at_all`` (Parallel_Life_MPI.cpp:175),
    every process writes the shards it holds."""
    return mesh.is_lead()


def run(cfg: RunConfig) -> RunResult:
    configure_logging(cfg.verbose)
    # join a multi-process job if the environment describes one (the
    # MPI_Init analogue), before any device is touched
    init_distributed(cfg.device)
    run_id = obs.new_run_id()
    # the trace file is a single-writer side effect, lead-only like the
    # metrics sink; spans are no-ops on the other processes
    tracer = (
        obs.start_tracing(cfg.trace_events, run_id=run_id)
        if cfg.trace_events and _is_lead_process()
        else None
    )
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
        # stochastic-tier gating before any backend is built: an executor
        # without the counter-based key schedule is a typed rejection, and
        # the (rule, temperature) pairing is validated once for every front
        mc.ensure_backend_supported(rule, cfg.backend)
        mc.validate_params(rule, cfg.temperature)
        # board area vs the PRNG counter's width: the packed path (the
        # default of cuda and torch) carries the wide two-word cell index,
        # the roll path rejects over-2^32-cell lattices
        mc.validate_board_shape(
            rule,
            (height, width),
            wide_counter=mc.wide_counter_capable(rule, cfg.backend, bitpack=cfg.bitpack),
        )
        validate_rule_geometry(rule, (height, width))

    timer = Timer()  # spans I/O too, like the reference's Wtime bracket

    backend_name = cfg.backend
    tuned = None  # TunedConfig once "tuned" resolves, else None
    if backend_name == "tuned":
        # autotune resolution: cache hit -> tuned knobs; miss -> the cost
        # model, or (tune_mode="measure") the measured search, which
        # persists its winner so the next run is a cache hit.  Resolved
        # BEFORE the mesh-shape check, so a tuned pick of the sharded
        # backend composes with an explicit --mesh-shape.
        from tpu_life_torch import autotune

        with obs.span("autotune-resolve"):
            key = autotune.tune_key_for(rule, (height, width), device=cfg.device)
            tuned, source = autotune.resolve(key, mode=cfg.tune_mode, shape=(height, width))
            if source != "cache" and cfg.tune_mode == "measure":
                result = autotune.tune(key, rule, shape=(height, width))
                tuned, source = result.best, "measured"
            # the pick and where it came from, for a trace's reader
            obs.instant("autotune-pick", key=key.id(), pick=tuned.describe(), source=source)
        log.info("autotune: %s -> %s (%s)", key.id(), tuned.describe(), source)
        backend_name = tuned.backend
        if cfg.mesh_shape is not None and backend_name != "sharded":
            # the JAX driver's mesh-shape check, after resolution: a mesh
            # shape only means something to a sharded pick
            raise ValueError(f"--mesh-shape requires the sharded backend, got {backend_name!r}")
    elif cfg.tune_mode not in ("off", "cache", "measure"):
        raise ValueError(f"tune_mode must be off|cache|measure, got {cfg.tune_mode!r}")

    # the knobs an explicit flag pinned (--block-steps, --local-kernel,
    # --no-bitpack, --stencil); tuned knobs fill in the rest through the
    # autotuner's one merge rule, so a flag always wins over the cache
    backend_kwargs: dict = {"device": cfg.device}
    if cfg.block_steps is not None:
        backend_kwargs["block_steps"] = cfg.block_steps
    if cfg.local_kernel != "auto":
        backend_kwargs["local_kernel"] = cfg.local_kernel
    if not cfg.bitpack:
        backend_kwargs["bitpack"] = False
    if cfg.stencil != "auto":
        backend_kwargs["stencil"] = cfg.stencil
    if tuned is not None:
        autotune.merge_knobs(tuned, backend_kwargs)
    backend_kwargs.setdefault("bitpack", True)
    backend_kwargs.setdefault("stencil", "auto")
    local_kernel = backend_kwargs.pop("local_kernel", "auto")
    if backend_name == "sharded":
        backend_kwargs.update(num_devices=cfg.num_devices, mesh_shape=cfg.mesh_shape,
                              local_kernel=local_kernel, partition_mode=cfg.partition_mode)
    elif backend_name == "stripes":
        # the stripe count, as the JAX driver passes it
        backend_kwargs["num_devices"] = cfg.num_devices
    registry = obs.MetricsRegistry()
    builds = registry.counter(
        "run_backend_builds_total",
        "backend (re)builds: the first and one a restart",
        labels=("backend",),
    )
    with obs.span("backend-build", backend=backend_name):
        # the rule hint sends `auto` to the float path for continuous rules
        backend = get_backend(backend_name, rule=rule, **backend_kwargs)
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

    can_stream = hasattr(backend, "prepare_from_file")
    stream = (
        cfg.stream_io
        if cfg.stream_io is not None
        # auto-stream only when the result goes to a file (a library caller
        # with no output_file needs RunResult.board), from a file (a seeded
        # board is made whole on the host), and of digits (a continuous
        # rule's float32 file is read and written whole)
        else can_stream
        and bool(cfg.output_file)
        and input_path is not None
        and not rule.continuous
        and height * width >= _STREAM_AUTO_CELLS
    )
    if not stream and not _single_process():
        raise ValueError(
            f"a run across {mesh.process_count()} processes writes its board per shard and "
            f"never gathers it: pass --stream-io (the sharded backend)"
        )
    if stream and not can_stream:
        raise ValueError(f"--stream-io needs the sharded backend (got backend {backend_name!r})")
    if stream and input_path is None:
        raise ValueError(
            f"stream_io needs an input file to stream from; {cfg.input_file!r} does not exist"
        )
    if (
        stream
        and not cfg.output_file
        and cfg.snapshot_every <= 0
        and not cfg.metrics
        and not cfg.metrics_file
    ):
        # a streamed run's board is never whole on the host: with no output
        # file, no snapshots and no metrics it would compute into the void
        raise ValueError(
            "stream_io=True produces no host board; pass output_file, "
            "snapshot_every or metrics, or use stream_io=False to get "
            "RunResult.board"
        )

    origin = (input_path, start_step)  # restart target when no snapshot exists
    fault_fired: list[bool] = []

    def build_runner(source, start):
        """The runner staged from a contract-format file (``source=None``:
        the seeded board), shard by shard when streamed.  Called once up
        front and again after each elastic-recovery restart, with the
        rebuilt ``backend``."""
        with obs.span("stage", resume_step=start):
            if stream:
                r = backend.prepare_from_file(source, height, width, rule)
            elif source is None:
                if rule.continuous:
                    b = lenia.seeded_board(height, width, seed=cfg.seed)
                elif (dev := _staging_device(backend)) is not None:
                    # drawn on the card (kernel K7), the numpy board's bytes
                    b = seeded_board(height, width, states=rule.states, seed=cfg.seed,
                                     device=dev).cpu().numpy()
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
            if not stream:
                r = make_runner(backend, b, rule, seed=cfg.seed, temperature=cfg.temperature,
                                start_step=start)
            if cfg.fault_at > 0:
                r = recovery.FaultingRunner(r, start, cfg.fault_at, fault_fired, cfg.fault_count)
        return r

    remaining = max(0, steps - start_step)
    recorder = MetricsRecorder(
        height * width,
        # enabled on every process alike: the live count is a reduction over
        # the processes, which a lead-only recorder would leave hanging
        cfg.metrics or cfg.verbose or bool(cfg.metrics_file),
        start_step=start_step,
        # the sink is a single-writer side effect: lead-only.  A raw append
        # log: recovery rewinds may repeat steps there (RunResult.metrics is
        # the deduplicated record)
        sink=cfg.metrics_file if _is_lead_process() else None,
        run_id=run_id,
        registry=registry,
        labels={"backend": backend.name, "rule": rule.name},
    )

    chunk = cfg.sync_every
    if chunk <= 0 and tuned is not None and tuned.sync_every > 0:
        chunk = tuned.sync_every
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
    # retention pruning and sidecars are single-writer side effects
    lead_snapshots = _is_lead_process()

    def write_streamed(path: Path) -> None:
        """The board per shard into ``path``: published atomically by one
        process; in a job of several, every process writes its shards into
        the one file directly (no rename can publish a file several
        processes write), and they wait for each other before it counts
        as written."""
        path.parent.mkdir(parents=True, exist_ok=True)
        if _single_process():
            with ckpt.atomic_publish(path) as tmp:
                backend.write_runner_to_file(recovery.unwrap(runner), tmp, height, width, rule)
        else:
            backend.write_runner_to_file(recovery.unwrap(runner), path, height, width, rule)
            mesh.barrier()

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
                if stream:
                    # per-shard snapshot: the board stays sharded
                    p = ckpt.snapshot_path(cfg.snapshot_dir, done)
                    write_streamed(p)
                    if lead_snapshots:
                        ckpt.write_sidecar(p, done, rule.name, height, width)
                else:
                    p = ckpt.save_snapshot(
                        cfg.snapshot_dir,
                        done,
                        board_np if board_np is not None else get_board(),
                        rule=rule.name,
                    )
                state["written"].append(done)
                log.info("snapshot step=%d -> %s", done, p)
                if cfg.keep_snapshots > 0 and lead_snapshots:
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
    # elastic recovery is process-local: in a job of several processes the
    # others would keep their transfers posted (or rewind to another step)
    # while this one restarts, so there the unit of recovery is the whole
    # job, relaunched with --resume
    max_restarts = cfg.max_restarts
    if max_restarts > 0 and not _single_process():
        log.warning(
            "multi-process job: in-process elastic recovery disabled; "
            "on failure, relaunch the whole job with --resume %s",
            cfg.snapshot_dir,
        )
        max_restarts = 0
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
                                backend = get_backend(backend_name, rule=rule, **backend_kwargs)
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
                    # the final gather, or the streamed per-shard output
                    # write, is as killable as any step, so it sits inside
                    # the recovery scope too
                    if stream:
                        if cfg.output_file:
                            with obs.span("output-write", streamed=True):
                                write_streamed(Path(cfg.output_file))
                    else:
                        with obs.span("gather"):
                            board = runner.fetch()
                    break
                except recovery.RECOVERABLE as e:
                    if isinstance(e, recovery.FATAL) or restarts >= max_restarts:
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
                        type(e).__name__, e, restarts, max_restarts, pending[0], pending[1],
                    )
                    if cfg.restart_wait_s > 0:
                        time.sleep(cfg.restart_wait_s)
        lead = _is_lead_process()
        if cfg.output_file and not stream and lead:
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
    if lead:
        print(f"Total time = {elapsed}")
    return RunResult(
        board=board,
        steps_run=remaining,
        elapsed_s=elapsed,
        backend=backend.name,
        rule=rule.name,
        route=getattr(recovery.unwrap(runner), "route", backend.name),
        seed=cfg.seed if (rule.stochastic or origin[0] is None) else None,
        temperature=cfg.temperature,
        metrics=recorder.records,
        restarts=restarts,
        run_id=run_id,
    )
