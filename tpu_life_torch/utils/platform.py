"""The devices a serving process budgets for.

:func:`device_info` is the port's counterpart of the JAX package's
``utils.platform.device_info``: ``(device count, platform kind)``.  The
port reads them from ``torch.cuda`` — no plugin can wedge that query, so
the JAX package's watchdogged probe (``devices_with_watchdog``) waits for
the port of its autotuner and CLI probes (ROADMAP A10).
"""

from __future__ import annotations

import torch


def device_info(timeout_s: float | None = None, *, device=None) -> tuple[int, str]:
    """``(count, kind)`` of the devices a service on ``device`` runs on:
    the visible cards and ``"cuda"``, or ``(1, "cpu")`` when the caller asks
    for the CPU or the machine has no card.  ``timeout_s`` is the JAX
    signature's probe bound; the ``torch.cuda`` query does not block."""
    if device is not None and torch.device(device).type == "cpu":
        return 1, "cpu"
    if not torch.cuda.is_available():
        return 1, "cpu"
    return torch.cuda.device_count(), "cuda"
