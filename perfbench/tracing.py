"""The traced window: ``torch.profiler`` over the measured window, reduced
to what the per-layer metrics and the result's ``breakdown`` read.

The harness marks its own calls into the program with host spans
(``torch.profiler.record_function``, names starting ``perfbench.``); the
window itself is the span ``perfbench.window``.  From the profiler's
records this module takes:

- the device's operations (kernels, copies, sets) inside the window, by
  name, with their count and seconds;
- ``busy_s``: the union of those operations' intervals, and ``window_s``:
  the window's length, so the idle share is ``1 - busy_s / window_s``;
- the gaps in which the device ran nothing, each named by the harness span
  and the innermost host operation under way at its middle.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import torch

WINDOW = "perfbench.window"
SPAN_PREFIX = "perfbench."
TOP = 10  # entries of each breakdown list
_SCAN_BACK = 256  # host records looked at to name a gap


def span(name: str, enabled: bool):
    """A host span of the harness, recorded only in a traced run."""
    if enabled:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return nullcontext()


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespaces and
    parameter list: ``packed_stripe_kernel<8, Conway>``."""
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    name = re.sub(r"^void ", "", name)
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


@dataclass
class TraceWindow:
    window_s: float
    busy_s: float
    #: device operations by full name: [count, seconds]
    device_ops: dict = field(default_factory=dict)
    #: idle seconds by what the host was doing: [count, seconds]
    idle: dict = field(default_factory=dict)
    #: host seconds inside each harness span: [count, seconds]
    spans: dict = field(default_factory=dict)

    def kernels(self, *names: str) -> tuple[int, float]:
        """(launches, device seconds) of the operations whose name contains
        any of ``names``."""
        count, seconds = 0, 0.0
        for name, (n, s) in self.device_ops.items():
            if any(k in name for k in names):
                count += n
                seconds += s
        return count, seconds

    def idle_pct(self) -> float:
        """The share of the window in which the device ran nothing."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        ops: dict = defaultdict(float)
        for name, (_, s) in self.device_ops.items():
            ops[short_name(name)] += s
        top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(((k, s) for k, (_, s) in self.idle.items()), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in top_ops],
                "idle_gaps": [[k, v] for k, v in gaps]}

    def host_spans(self) -> list:
        """[[span, calls, seconds], ...] of the harness's spans, longest
        first."""
        return [[k, n, s] for k, (n, s) in sorted(self.spans.items(), key=lambda kv: -kv[1][1])]


def _is_device(event) -> bool:
    return event.device_type() == torch.autograd.DeviceType.CUDA and not event.is_user_annotation()


def reduce_events(events) -> TraceWindow:
    """The window of the profiler's records ``events``
    (``kineto_results.events()``)."""
    windows = [e for e in events if e.name() == WINDOW and not _is_device(e)
               and e.device_type() == torch.autograd.DeviceType.CPU]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0 = windows[0].start_ns()
    w1 = w0 + windows[0].duration_ns()
    device, host, spans = [], [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if _is_device(e):
            a, b = max(start, w0), min(start + dur, w1)
            if b > a:
                device.append((a, b, e.name()))
        elif e.device_type() == torch.autograd.DeviceType.CPU and e.name() != WINDOW:
            rec = (start, start + dur, e.name())
            (spans if e.name().startswith(SPAN_PREFIX) else host).append(rec)
    ops: dict = defaultdict(lambda: [0, 0.0])
    for a, b, name in device:
        ops[name][0] += 1
        ops[name][1] += (b - a) * 1e-9
    busy_ns, gaps = 0, []
    cursor = w0
    for a, b, _ in sorted(device):
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy_ns += b - max(a, cursor)
            cursor = b
    if w1 > cursor:
        gaps.append((cursor, w1))
    idle: dict = defaultdict(lambda: [0, 0.0])
    host.sort()
    spans.sort()
    host_starts = [h[0] for h in host]
    span_starts = [s[0] for s in spans]
    for a, b in gaps:
        label = f"{_innermost(spans, span_starts, (a + b) // 2) or 'outside the harness spans'}"
        op = _innermost(host, host_starts, (a + b) // 2)
        if op:
            label += f" / {op}"
        idle[label][0] += 1
        idle[label][1] += (b - a) * 1e-9
    in_spans: dict = defaultdict(lambda: [0, 0.0])
    for a, b, name in spans:
        if min(b, w1) > max(a, w0):
            in_spans[name][0] += 1
            in_spans[name][1] += (min(b, w1) - max(a, w0)) * 1e-9
    return TraceWindow(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                       device_ops={k: list(v) for k, v in ops.items()},
                       idle={k: list(v) for k, v in idle.items()},
                       spans={k: list(v) for k, v in in_spans.items()})


def _innermost(records, starts, t) -> str | None:
    """The name of the latest-started record that covers ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - _SCAN_BACK), -1):
        if records[j][1] >= t:
            return records[j][2]
    return None


@contextmanager
def profiled(result: list):
    """Profile the body (host and device); append its
    :class:`TraceWindow` to ``result``.  The body runs the window inside
    ``span("window", True)``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    result.append(reduce_events(prof.profiler.kineto_results.events()))
