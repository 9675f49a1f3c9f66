"""Spans on ``torch.profiler``'s clock, for work inside the Runners and the
kernel wrappers.

:func:`profiler_span` marks such work once a call, for a
``torch.profiler`` trace only (``--profile``, the benchmark's traced
runs): there it lands as a ``tpu_life_torch.<name>`` record on the same
clock as the card's kernels and copies, which the obs ring's
``perf_counter`` is not.  It never enters that ring
(:mod:`tpu_life_torch.obs.trace`), whose events stay host phases, and
with the profiler off it returns the ring's shared ``nullcontext`` after
one dict lookup and one flag read.  It imports no torch: a process that
never loaded torch is never profiled.
"""

from __future__ import annotations

import sys

from tpu_life_torch.obs.trace import _NULL

#: the prefix of every :func:`profiler_span` record's name
PREFIX = "tpu_life_torch."


def profiler_span(name: str):
    """A user-scope record function named ``PREFIX + name`` while the
    profiler records, else the shared ``nullcontext``.  The record is
    ``torch.profiler.record_function``'s, made by its C++ context manager
    (the one compiled code uses): about 2 us a span under the profiler,
    against 14 through ``record_function`` (on a CPU), so that the spans
    of a 4-ms board chunk add little to the traced device idle."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return _NULL
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)
