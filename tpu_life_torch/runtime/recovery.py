"""Failure detection + elastic recovery (from ``tpu_life/runtime/recovery.py``).

On the card the failures a run can outlive surface as ``RuntimeError``
from a step: a kernel launch that returns a CUDA error, a
``torch.cuda.OutOfMemoryError``, a device lost under the process.  The
driver treats those as *recoverable*: it rebuilds the backend, resumes
from the newest snapshot this run wrote (or the original input when none
exists yet), and re-runs the lost steps, up to ``--max-restarts`` times.

Two RuntimeErrors are not: a machine without a card
(``backends.base.CudaUnavailableError``) and a kernel source that does not
build (``kernels._build.KernelBuildError``).  Kernels build at their first
launch, inside the recovery loop, and a rebuild fails the same way, so
:data:`FATAL` names them and the driver raises them at once.  Config and
user errors (ValueError, FileNotFoundError, KeyError) are never
recoverable.

``--fault-at N`` is the matching fault-injection drill: a proxy Runner
raises a simulated device loss the first time the run would cross
absolute step N, exercising exactly the recovery path a real failure
takes.

What recovery can NOT do in-process: a launch that *hangs* never returns
control.  And a sticky CUDA fault, such as an illegal address, poisons
the process's CUDA context: every later launch and copy fails too, so an
in-process rebuild fails again until the restart budget is spent, and the
error is raised.  The recovery unit for those is the process: relaunch it
with ``--resume``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from tpu_life_torch.backends.base import CudaUnavailableError
from tpu_life_torch.kernels._build import KernelBuildError


class InjectedFault(RuntimeError):
    """Simulated device loss, raised by the ``--fault-at`` drill."""


#: Exception types the driver may recover from by rebuilding + resuming.
#: Device/runtime loss (a CUDA error, out of memory) subclasses
#: RuntimeError; config and user errors (ValueError, FileNotFoundError,
#: KeyError) never match, so a typo cannot silently burn restart attempts.
RECOVERABLE: tuple[type[BaseException], ...] = (RuntimeError,)

#: RuntimeErrors no rebuild can mend, raised on the first attempt: no card,
#: and a kernel that does not build.
FATAL: tuple[type[BaseException], ...] = (CudaUnavailableError, KernelBuildError)


#: Message markers that identify a device out-of-memory among the
#: RECOVERABLE family.  ``torch.cuda.OutOfMemoryError`` says "CUDA out of
#: memory"; the JAX package's markers are kept so the classifier reads
#: both packages' errors alike.
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "Out of memory")


def is_oom(e: BaseException) -> bool:
    """True when a RECOVERABLE error is a device out-of-memory: the one
    failure shape the serving tier answers with its own ladder (halve the
    chunk, then demote the key to its host engine) rather than a plain
    rebuild-and-replay.  A FATAL error is never one, whatever its text
    (an nvcc killed for memory): no demotion stands in for a kernel."""
    if isinstance(e, FATAL):
        return False
    msg = str(e)
    return any(m in msg for m in _OOM_MARKERS)


def unwrap(runner):
    """The backend's own Runner behind a possible ``FaultingRunner`` proxy
    (the driver reads its ``route``)."""
    return runner._inner if isinstance(runner, FaultingRunner) else runner


class FaultingRunner:
    """Runner proxy that raises ``InjectedFault`` in ``advance`` — where a
    real device failure would surface — when the run *crosses* absolute
    step ``fault_at`` (a run resumed at or past ``fault_at`` has already
    crossed it and is left alone).

    ``fired`` is a list shared across restarts (one entry per firing), so
    the drill kills the run ``fault_count`` times per ``driver.run`` call:
    after recovery rewinds to a snapshot before ``fault_at``, the re-wrapped
    runner fires again until the budget is spent — which is how the
    multi-failure / budget-exhaustion paths get exercised.
    """

    def __init__(
        self,
        inner,
        start_step: int,
        fault_at: int,
        fired: list[bool],
        fault_count: int = 1,
    ):
        self._inner = inner
        self._done = start_step
        self._fault_at = fault_at
        self._fired = fired
        self._fault_count = fault_count

    def advance(self, steps: int) -> None:
        if (
            len(self._fired) < self._fault_count
            and self._done < self._fault_at <= self._done + steps
        ):
            self._fired.append(True)
            raise InjectedFault(
                f"injected device failure crossing step {self._fault_at} "
                f"({len(self._fired)}/{self._fault_count})"
            )
        self._inner.advance(steps)
        self._done += steps

    def sync(self) -> None:
        self._inner.sync()

    def fetch(self) -> np.ndarray:
        return self._inner.fetch()

    def snapshot(self) -> Callable[[], np.ndarray]:
        return self._inner.snapshot()

    def live_count(self) -> int:
        return self._inner.live_count()
