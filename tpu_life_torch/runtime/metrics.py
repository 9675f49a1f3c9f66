"""Structured run metrics (a copy of ``tpu_life/runtime/metrics.py``).

At each host-sync chunk the recorder logs the step index, the live-cell
count, steps/sec and cell-updates/sec; the run still ends with the
reference's ``Total time = <s>`` line.  It sits on
:class:`tpu_life_torch.obs.MetricsRegistry`: every record carries the
invocation's ``run_id`` and a wall-clock ``ts``, per-chunk durations feed a
histogram, and :meth:`MetricsRecorder.close` appends the registry snapshot
(``kind: "metric"`` records) to the same JSONL sink, whose records have
the JAX package's keys.  The live count comes from ``Runner.live_count``,
a reduction on the device: one scalar a shard crosses to the host, never
the board.
"""

from __future__ import annotations

import json
import logging
import sys
import time

import numpy as np

from tpu_life_torch import obs

log = logging.getLogger("tpu_life_torch")


def configure_logging(verbose: bool) -> None:
    if not log.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
        log.addHandler(h)
    # we attach our own handler, so records must not ALSO propagate to the
    # root logger — under pytest (or any app with a root handler) every
    # line used to print twice
    log.propagate = False
    log.setLevel(logging.DEBUG if verbose else logging.INFO)


class MetricsRecorder:
    def __init__(
        self,
        cell_count: int,
        enabled: bool,
        start_step: int = 0,
        sink: str | None = None,
        run_id: str | None = None,
        registry: obs.MetricsRegistry | None = None,
        labels: dict | None = None,
    ):
        self.cell_count = cell_count
        self.enabled = enabled or sink is not None
        self.start_step = start_step  # rates count only this run's steps
        self.records: list[dict] = []
        self.run_id = run_id or obs.new_run_id()
        self.registry = registry if registry is not None else obs.MetricsRegistry()
        self.sink = sink  # append each record as a JSON line here
        self._sink_handle = None  # persistent handle, flushed per record
        if sink:
            # open eagerly: a missing parent directory must fail HERE, at
            # construction, not minutes later when the first chunk syncs
            # (the old lazy open discarded a whole run's compute on a typo)
            obs.ensure_parent(sink)
            self._sink_handle = open(sink, "a")
        # bounded labels (backend, rule) on the run instruments; the chunk
        # histogram answers "how even are my host-sync chunks" and the step
        # counter makes multi-run sinks aggregable
        self._labels = dict(labels or {})
        labelnames = tuple(self._labels)
        self._chunk_seconds = self.registry.histogram(
            "run_chunk_seconds",
            "wall seconds per host-sync chunk",
            labels=labelnames,
        )
        self._steps_total = self.registry.counter(
            "run_steps_total", "simulation steps completed", labels=labelnames
        )
        self._last_elapsed = 0.0
        self._last_done = 0

    def _inst(self, family):
        return family.labels(**self._labels) if self._labels else family

    def record(self, rec: dict) -> None:
        """Append an arbitrary record (and mirror it to the JSONL sink).

        The generic entry point: ``record_chunk`` builds the per-chunk
        simulation record, the serving layer emits per-round queue/batch
        records — both land in the same ``records`` list and sink file,
        stamped with the run's correlation id and a wall-clock ``ts``.
        """
        if not self.enabled:
            return
        rec.setdefault("run_id", self.run_id)
        rec.setdefault("ts", time.time())
        self.records.append(rec)
        self._write_sink(rec)

    def _write_sink(self, rec: dict) -> None:
        # one persistent append handle, flushed per record: a JSONL
        # consumer tailing the sink sees each complete line as soon as the
        # chunk that produced it syncs, and a killed run loses nothing
        if not self.sink:
            return
        if self._sink_handle is None:
            # a recorder that keeps recording after close() reopens the
            # sink (append) — close-then-continue keeps its records
            self._sink_handle = open(self.sink, "a")
        self._sink_handle.write(json.dumps(rec) + "\n")
        self._sink_handle.flush()

    def flush_registry(self) -> None:
        """Append the registry snapshot (``kind: "metric"`` records) to the
        sink.  Snapshot lines go to the sink only — ``records`` (and so
        ``RunResult.metrics``) stays the per-chunk stream it always was."""
        if not self.sink:
            return
        for rec in self.registry.snapshot(run_id=self.run_id):
            rec["ts"] = time.time()
            self._write_sink(rec)

    def close(self) -> None:
        if self._sink_handle is not None:
            self.flush_registry()
            self._sink_handle.close()
            self._sink_handle = None

    def record_chunk(self, step: int, elapsed: float, live: int) -> None:
        """Record one host-sync chunk.  ``live`` comes from the runner's
        on-device sharded reduction (``Runner.live_count``) — the recorder
        never sees the board, so metrics cannot force a gather (SURVEY.md §5
        "live-cell count via sharded reduction")."""
        if not self.enabled:
            return
        done = step - self.start_step
        # rates report 0.0 (not NaN) when no time has elapsed: NaN is not
        # valid JSON, so a single zero-elapsed chunk used to poison the
        # JSONL sink for strict parsers downstream
        rec = {
            "step": step,
            "elapsed_s": elapsed,
            "live_cells": live,
            "steps_per_sec": done / elapsed if elapsed > 0 else 0.0,
            "cell_updates_per_sec": done * self.cell_count / elapsed
            if elapsed > 0
            else 0.0,
        }
        self._inst(self._chunk_seconds).observe(
            max(0.0, elapsed - self._last_elapsed)
        )
        self._last_elapsed = max(self._last_elapsed, elapsed)
        # counters take per-chunk deltas (done is cumulative; a recovery
        # rewind may send it backwards — clamp, never double-count)
        self._inst(self._steps_total).inc(max(0, done - self._last_done))
        self._last_done = max(self._last_done, done)
        self.record(rec)
        log.info(
            "step=%d live=%d steps/s=%.2f cells/s=%.3e",
            step,
            live,
            rec["steps_per_sec"],
            rec["cell_updates_per_sec"],
        )


def dump_board(board: np.ndarray, max_size: int = 64) -> str:
    """Small-board ASCII dump — the reference's commented-out debug print
    (Parallel_Life_MPI.cpp:223-229), resurrected behind --verbose."""
    h, w = board.shape
    if h > max_size or w > max_size:
        return f"<board {h}x{w} too large to dump>"
    return "\n".join("".join(str(int(c)) for c in row) for row in board)
