"""Profiling hooks (from ``tpu_life/runtime/profiling.py``).

``--profile DIR`` wraps the run's drive in a ``torch.profiler`` trace
(host activity, and the card's kernels and copies when there is one) and
exports it into ``DIR`` as Chrome trace-event JSON, viewable in Perfetto:
the per-kernel breakdown the single ``Total time`` line cannot give.

Composes with ``--trace-events`` span tracing (tpu_life_torch.obs): when
both are on, the profile's extent appears as a ``torch-profile`` span in
the host trace (the JAX package's ``jax-profile`` span under this port's
name), so the two timelines can be aligned by run_id + offset.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

from tpu_life_torch import obs


@contextmanager
def _trace(trace_dir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with obs.span("torch-profile", trace_dir=trace_dir):
        prof = profile(activities=activities)
        try:
            with prof:
                yield
        finally:
            # a failed run still leaves what was profiled, like its trace
            Path(trace_dir).mkdir(parents=True, exist_ok=True)
            out = Path(trace_dir) / f"{os.getpid()}.{time.time_ns()}.pt.trace.json"
            prof.export_chrome_trace(str(out))


def maybe_profile(trace_dir: str | None):
    return _trace(trace_dir) if trace_dir else nullcontext()
