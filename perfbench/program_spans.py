"""The program's own spans in the traced window.

The program marks work inside its Runners and kernel wrappers with
``torch.profiler`` records named ``tpu_life_torch.<name>``
(``obs.profiler_span``), on the clock of the card's kernels and copies.
For each such name :func:`reduce` gives its calls, its seconds in the
window and the device's idle seconds inside it: the measure of the gaps
in which the device ran nothing, intersected with the span's intervals.

The harness's reduction (:func:`tracing.reduce_events`) keeps no program
span.  :func:`install` wraps it so that the :class:`tracing.TraceWindow`
it returns also carries ``program``, computed from the same records; the
harness's fields are computed by the harness's code, as before.  The
readers of the program's spans install it when the harness loads them,
which is before the window opens.  A program without such spans leaves
``program`` empty.
"""

from __future__ import annotations

import bisect
import functools
from collections import defaultdict

import torch

from perfbench import tracing

PREFIX = "tpu_life_torch."


def _window(events) -> tuple[int, int]:
    for e in events:
        if (e.name() == tracing.WINDOW and not tracing._is_device(e)
                and e.device_type() == torch.autograd.DeviceType.CPU):
            return e.start_ns(), e.start_ns() + e.duration_ns()
    raise RuntimeError(f"the trace holds no {tracing.WINDOW!r} span")


def reduce(events) -> dict:
    """``{name: [calls, seconds in the window, idle seconds inside]}`` of
    the program's spans among the profiler's records ``events``."""
    w0, w1 = _window(events)
    device, program = [], []
    for e in events:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if tracing._is_device(e):
            if min(b, w1) > max(a, w0):
                device.append((max(a, w0), min(b, w1)))
        elif e.device_type() == torch.autograd.DeviceType.CPU and e.name().startswith(PREFIX):
            program.append((a, b, e.name()))
    gaps, cursor = [], w0
    for a, b in sorted(device):
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if w1 > cursor:
        gaps.append((cursor, w1))
    starts = [a for a, _ in gaps]
    before = [0]  # the idle ns before each gap
    for a, b in gaps:
        before.append(before[-1] + b - a)

    def idle_until(t: int) -> int:
        i = bisect.bisect_right(starts, t)
        return before[i] - max(0, gaps[i - 1][1] - t) if i else 0

    spans: dict = defaultdict(lambda: [0, 0.0, 0.0])
    for a, b, name in program:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            spans[name][0] += 1
            spans[name][1] += (b - a) * 1e-9
            spans[name][2] += (idle_until(b) - idle_until(a)) * 1e-9
    return {k: list(v) for k, v in spans.items()}


def install() -> None:
    """Wrap :func:`tracing.reduce_events` once, adding ``program``."""
    if hasattr(tracing.reduce_events, "__wrapped__"):
        return
    harness_reduce = tracing.reduce_events

    @functools.wraps(harness_reduce)
    def reduce_events(events):
        events = list(events)
        trace = harness_reduce(events)
        trace.program = reduce(events)
        return trace

    tracing.reduce_events = reduce_events

