"""The plain references of the benchmark's configurations, one module each
(named by the ``reference`` key of a configuration's file), each with
``advance`` and the ``control_advance`` that breaks one guarantee the
configuration states.  Plain PyTorch and NumPy: nothing here imports the
program under test."""

from __future__ import annotations

import numpy as np


def mismatches(a, b) -> int:
    """Cells at which two boards (or batches of boards) differ; boards of
    different shapes differ everywhere."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int(np.count_nonzero(a != b))
