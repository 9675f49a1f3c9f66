"""Wall-clock timing (a copy of ``tpu_life/utils/timing.py``'s ``Timer``
and ``delta_seconds_per_step``).

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
