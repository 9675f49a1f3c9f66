"""The device probe and the devices a serving process budgets for.

:func:`devices_with_watchdog` is the port's counterpart of the JAX
package's probe of the same name: the card's first query
(``torch.cuda.init()`` and ``device_count()``) runs in a daemon thread
under a timeout (``TPU_LIFE_DEVICE_TIMEOUT_S``), so a wedged driver ends
in a :class:`TimeoutError` and an exit instead of a hang.  The CLI primes
it before ``run``, ``bench``, ``tune``, ``serve`` and ``sweep`` on the
card; ``--device cpu`` skips it, and it never turns a card run into a CPU
run.  :func:`device_info` is the JAX ``device_info``: ``(device count,
platform kind)``.
"""

from __future__ import annotations

import os

import torch

DEVICE_QUERY_TIMEOUT_S = 180.0


def devices_with_watchdog(timeout_s: float | None = None) -> int:
    """The number of CUDA devices (0 without a card), from a query that
    cannot hang the process forever.  The query runs in a daemon thread; on expiry a
    TimeoutError says how to recover (the stuck thread is abandoned:
    callers are expected to exit).  A query that fails re-raises its
    error here."""
    import threading

    if timeout_s is None:
        timeout_s = float(os.environ.get("TPU_LIFE_DEVICE_TIMEOUT_S", DEVICE_QUERY_TIMEOUT_S))
    result: dict = {}

    def query() -> None:
        try:
            if not torch.cuda.is_available():
                # no card: 0, and the backend raises its tidy error later
                result["count"] = 0
                return
            torch.cuda.init()
            result["count"] = torch.cuda.device_count()
        except Exception as e:  # noqa: BLE001 — re-raised on the caller side
            result["error"] = e

    t = threading.Thread(target=query, daemon=True, name="device-watchdog")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise TimeoutError(
            f"CUDA device query hung for {timeout_s:.0f}s: the driver or the card "
            "appears wedged.  Check the card with nvidia-smi and retry; run on the "
            "CPU with --device cpu (the plain PyTorch versions) or --backend numpy; "
            "TPU_LIFE_DEVICE_TIMEOUT_S sets this bound."
        )
    if "error" in result:
        raise result["error"]
    return result["count"]


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
