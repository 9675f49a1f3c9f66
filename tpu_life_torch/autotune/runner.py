"""Measured trials: time each candidate on the live device, pick the min
(``tpu_life/autotune/runner.py``).

Per candidate the board is staged once (the ``make_runner`` seam — the
same path the driver runs), one warmup advance absorbs the kernel builds
and the staging, then ``trials`` timed advances, each closed by
``runner.sync()`` (the card's stream drained), are taken and the
**median** seconds/step reported.

Failure isolation is per candidate: a candidate whose backend refuses to
construct (mesh divisibility, kernel constraints) or crashes mid-trial is
recorded as infeasible with its error string and the search continues —
one broken configuration must never abort the sweep that would route
around it.  The one departure from the JAX runner: a kernel that does not
build (``KernelBuildError``) or a native codec that does not build
(``NativeBuildError``) propagates.  A broken build fails the same way on
every retry, and recording it as infeasible would quietly make the tuner
pick a plain-ops route.

``trial_count()`` is the measurement probe: every timed trial the process
runs increments it, so tests (and the serve read path's never-measure
guarantee) can assert exactly how many device measurements an operation
performed.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import numpy as np

from tpu_life_torch import obs
from tpu_life_torch.autotune.space import TuneKey, TunedConfig
from tpu_life_torch.kernels._build import KernelBuildError
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.utils.nativelib import NativeBuildError

# measurement probe (see module docstring); mutable holder so callers keep
# a live view through the module, not a stale int import
_MEASURED = {"trials": 0}

# steps per timed trial and warmup steps on the card (see
# default_trial_steps).  tpu_life_torch/experiments/tune_fit.py measured
# the spread, (max - min) / median of 7 trials, of cuda and sharded (K3)
# at k = 8 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6, PR 20): at
# 16384^2 19% at 16 steps, 2.3-4.5% at 64, 1.9-3.3% at 256; at 4096^2,
# where a step is ~2 us and the host paces the launches, 18-139% at every
# count.  256 steps give the least spread at the size the main path runs.
TRIAL_STEPS_CUDA = (256, 16)


def trial_count() -> int:
    """Timed trials this process has run (the never-measure probe)."""
    return _MEASURED["trials"]


def reset_trial_count() -> None:
    _MEASURED["trials"] = 0


@dataclass
class TrialResult:
    config: TunedConfig
    seconds_per_step: float | None  # None => infeasible
    error: str | None = None
    samples: list[float] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.seconds_per_step is not None


def make_trial_board(key: TuneKey, shape: tuple[int, int]) -> np.ndarray:
    """A representative random board: ~50% density, seeded so every
    candidate (and every re-tune) measures the same workload."""
    rng = np.random.default_rng(0)
    h, w = shape
    board = rng.integers(0, 2, size=(h, w), dtype=np.int8)
    if key.states > 2:
        board *= rng.integers(1, key.states, size=(h, w), dtype=np.int8)
    return board


def _trial_runner_kwargs(rule: Rule) -> dict:
    """Per-rule ``make_runner`` extras for a trial.

    Stochastic rules consume the counter-based PRNG state: a fixed seed
    keeps every candidate (and every re-tune) on the same workload, and
    ising needs a temperature — measured at the critical point, the
    hardest-mixing (most acceptance-table-consulting) regime, so the
    tuned pick is honest for the worst case.
    """
    if not getattr(rule, "stochastic", False):
        return {}
    kw: dict = {"seed": 0}
    from tpu_life_torch.models.rules import IsingRule

    if isinstance(rule, IsingRule):
        from tpu_life_torch.mc.ising import T_CRITICAL

        kw["temperature"] = T_CRITICAL
    return kw


def _measure(
    cfg: TunedConfig,
    board: np.ndarray,
    rule: Rule,
    *,
    steps: int,
    warmup_steps: int,
    trials: int,
    device=None,
) -> tuple[float, list[float]]:
    """(median seconds/step, raw samples) of one candidate on ``device``
    (None: the card)."""
    from tpu_life_torch.backends.base import get_backend, make_runner

    backend = get_backend(cfg.backend, rule=rule, device=device, **cfg.backend_kwargs())
    runner = make_runner(backend, board, rule, **_trial_runner_kwargs(rule))
    runner.advance(warmup_steps)  # absorbs compilation + staging
    runner.sync()
    samples: list[float] = []
    for _ in range(max(1, trials)):
        _MEASURED["trials"] += 1
        t0 = time.perf_counter()
        runner.advance(steps)
        runner.sync()
        samples.append((time.perf_counter() - t0) / steps)
    return statistics.median(samples), samples


def default_trial_steps(device_kind: str) -> tuple[int, int]:
    """(steps per timed trial, warmup steps).  On the card: TRIAL_STEPS_CUDA,
    chosen from the trial-to-trial spread measured at 4096^2 and 16384^2
    (see its comment); CPU trials at 4096^2 are compute-bound at a handful
    of steps."""
    return TRIAL_STEPS_CUDA if device_kind == "cuda" else (4, 2)


def trial_device(key: TuneKey):
    """The device a key's trials run on: the CPU for a CPU key, else the
    card (None)."""
    return "cpu" if key.device_kind == "cpu" else None


def run_trials(
    key: TuneKey,
    candidates: list[TunedConfig],
    board: np.ndarray,
    rule: Rule,
    *,
    trials: int = 3,
    steps: int | None = None,
    warmup_steps: int | None = None,
    measure=None,
    on_trial=None,
) -> list[TrialResult]:
    """Measure every candidate; infeasible ones are recorded, never raised.

    ``measure`` injects a fake timing function for tests
    (``measure(cfg, board, rule) -> seconds_per_step``); ``on_trial`` is a
    progress callback ``(index, total, TrialResult)`` for the CLI table.
    """
    d_steps, d_warm = default_trial_steps(key.device_kind)
    steps = d_steps if steps is None else steps
    warmup_steps = d_warm if warmup_steps is None else warmup_steps
    results: list[TrialResult] = []
    for i, cfg in enumerate(candidates):
        # a span per candidate: a traced `run --tune-mode measure` (or
        # `tune` under tracing) shows where the search time went
        with obs.span("autotune.trial", candidate=cfg.describe()):
            try:
                if measure is not None:
                    sps = float(measure(cfg, board, rule))
                    res = TrialResult(cfg, sps, samples=[sps])
                else:
                    sps, samples = _measure(
                        cfg,
                        board,
                        rule,
                        steps=steps,
                        warmup_steps=warmup_steps,
                        trials=trials,
                        device=trial_device(key),
                    )
                    res = TrialResult(cfg, sps, samples=samples)
            except (KernelBuildError, NativeBuildError):
                raise  # a broken build is no infeasible candidate
            except Exception as e:  # noqa: BLE001 — per-candidate isolation
                res = TrialResult(cfg, None, error=f"{type(e).__name__}: {e}")
        results.append(res)
        if on_trial is not None:
            on_trial(i, len(candidates), res)
    return results


def best_result(results: list[TrialResult]) -> TrialResult | None:
    """The winner: minimum median seconds/step over feasible results,
    first-wins on exact ties (deterministic for a fixed candidate order).
    None when every candidate was infeasible."""
    ok = [r for r in results if r.ok]
    if not ok:
        return None
    return min(ok, key=lambda r: r.seconds_per_step)
