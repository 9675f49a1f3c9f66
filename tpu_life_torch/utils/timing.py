"""Wall-clock timing (a copy of ``tpu_life/utils/timing.py``'s ``Timer``,
``delta_seconds_per_step`` and ``paired_delta_seconds_per_step``).

``Timer`` brackets a whole run, I/O included.  Runners on a card must be
synchronised (``Runner.sync``) before a reading, or the clock measures
only the enqueue.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.start = time.perf_counter()

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.start


def delta_seconds_per_step(
    runner, steps: int, base_steps: int, repeats: int = 3
) -> float:
    """Sustained seconds/step of a Runner via delta timing.

    Two runs of different step counts are timed and differenced — the
    delta cancels the constant launch + readback latency.  The first pair
    of calls warms up (kernel build, allocator).  Negative deltas (timer
    noise) are discarded; if none are positive the plain per-step time of
    the long run is returned.
    """
    if steps <= base_steps:
        raise ValueError(f"steps {steps} must exceed base_steps {base_steps}")

    def timed(k: int) -> float:
        t0 = time.perf_counter()
        runner.advance(k)
        runner.sync()
        return time.perf_counter() - t0

    timed(base_steps)  # warmup
    timed(steps)
    deltas = [
        (timed(steps) - timed(base_steps)) / (steps - base_steps)
        for _ in range(repeats)
    ]
    positive = [d for d in deltas if d > 0]
    return min(positive) if positive else timed(steps) / steps


def paired_delta_seconds_per_step(
    runner_a, runner_b, steps: int, base_steps: int, repeats: int = 3
) -> list[tuple[float, float]]:
    """Per-step times of two Runners, measured as back-to-back delta PAIRS.

    Each repeat times runner_a's delta then runner_b's immediately after,
    so both sit in the same throughput window of a drifting device — the
    per-pair ratio cancels window-to-window wobble that timing two
    sequential `delta_seconds_per_step` calls would soak up.  Same warmup
    and positive-delta policy as `delta_seconds_per_step`; pairs where
    either delta is non-positive (timer noise) are dropped.  Returns the
    surviving (a, b) pairs.
    """
    if steps <= base_steps:
        raise ValueError(f"steps {steps} must exceed base_steps {base_steps}")
    span = steps - base_steps

    def timed(runner, k: int) -> float:
        t0 = time.perf_counter()
        runner.advance(k)
        runner.sync()
        return time.perf_counter() - t0

    for r in (runner_a, runner_b):  # warmup: both counts, both legs
        timed(r, base_steps)
        timed(r, steps)
    pairs = []
    for _ in range(repeats):
        d_a = (timed(runner_a, steps) - timed(runner_a, base_steps)) / span
        d_b = (timed(runner_b, steps) - timed(runner_b, base_steps)) / span
        if d_a > 0 and d_b > 0:
            pairs.append((d_a, d_b))
    return pairs
