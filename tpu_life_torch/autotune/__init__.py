"""Measured autotuning with a persistent per-device config cache
(``tpu_life/autotune`` under the port's names).

- :func:`tune` — the **write path**: enumerate the legal candidate space
  for a :class:`TuneKey` (device kind + count, rule structure, padded
  board-shape bucket), run short warm+timed trials with median-of-k timing
  and per-candidate failure isolation, persist the winner to the port's
  JSON cache (``~/.cache/tpu_life_torch/autotune.json``,
  ``TPU_LIFE_TORCH_AUTOTUNE_CACHE`` overrides).  Run offline via
  ``python -m tpu_life_torch tune``.
- :func:`resolve` — the **read path**: cache hit -> the tuned config; miss
  -> the analytic cost model (its constants fitted on the H100,
  ``cost_model``).  **Never measures** — safe on every latency-sensitive
  path (the serve engine resolves through it per CompileKey).

Integration points: ``RunConfig(backend="tuned", tune_mode=...)`` in the
driver, ``bench --backend tuned``, ``ServeConfig(backend="tuned")`` in the
serving stack, and the ``tune`` CLI mode.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpu_life_torch.autotune import cache, cost_model, runner, space
from tpu_life_torch.autotune.runner import (
    TrialResult,
    best_result,
    reset_trial_count,
    run_trials,
    trial_count,
)
from tpu_life_torch.autotune.space import (
    TuneKey,
    TunedConfig,
    default_backend_set,
    enumerate_candidates,
    tune_key_for,
    tuned_record,
)
from tpu_life_torch.models.rules import Rule, get_rule

TUNE_MODES = ("off", "cache", "measure")

__all__ = [
    "TuneKey",
    "TunedConfig",
    "TuneResult",
    "TrialResult",
    "TUNE_MODES",
    "tune",
    "resolve",
    "resolve_backend_kwargs",
    "merge_knobs",
    "tuned_record",
    "tune_key_for",
    "enumerate_candidates",
    "default_backend_set",
    "trial_count",
    "reset_trial_count",
    "cache",
    "cost_model",
    "runner",
    "space",
]


@dataclass
class TuneResult:
    """What one tuning search did: the full trial table plus the winner."""

    key: TuneKey
    results: list[TrialResult]
    best: TunedConfig
    source: str  # "measured" | "cost_model" (dry runs never measure)
    cache_file: str | None  # where the winner was persisted (None: not saved)


def resolve(
    key: TuneKey,
    *,
    mode: str = "cache",
    shape: tuple[int, int] | None = None,
    backend_set=None,
    cache_file=None,
) -> tuple[TunedConfig, str]:
    """The read path: ``(config, source)`` with source in
    ``{"cache", "cost_model"}``.  Never measures, regardless of mode —
    ``mode="off"`` additionally skips the cache read (pure cost model),
    ``mode="measure"`` is the *caller's* cue to run :func:`tune` on a
    miss (the driver does; the serve engine deliberately does not).
    """
    if mode not in TUNE_MODES:
        raise ValueError(f"tune_mode must be one of {TUNE_MODES}, got {mode!r}")
    if mode != "off":
        entry = cache.get(key, path=cache_file)
        if entry is not None:
            return TunedConfig.from_dict(entry["config"]), "cache"
    candidates = enumerate_candidates(key, backend_set=backend_set, shape=shape)
    return cost_model.choose(key, candidates), "cost_model"


def merge_knobs(tuned: TunedConfig, kwargs: dict) -> dict:
    """The one merge rule of a tuned pick and a caller's kwargs: tuned
    knobs fill in via ``setdefault``, so a knob the caller already pinned
    (an explicit flag) wins over the cache.  Returns ``kwargs``."""
    for k, v in tuned.backend_kwargs().items():
        kwargs.setdefault(k, v)
    return kwargs


def resolve_backend_kwargs(
    rule,
    shape: tuple[int, int],
    kwargs: dict,
    *,
    mode: str = "cache",
    cache_file=None,
    device=None,
) -> tuple[str, TunedConfig, str]:
    """Resolve the ``"tuned"`` pseudo-backend for a ``get_backend`` call
    site on ``device`` (None: the card): tuned knobs fill into ``kwargs``
    through :func:`merge_knobs`, so any knob the caller already pinned (an
    explicit flag) wins over the cache.

    The CLI bench's and the serve engine's resolution — returns
    ``(backend_name, tuned_config, source)``; read path only.
    """
    if isinstance(rule, str):
        rule = get_rule(rule)
    key = tune_key_for(rule, shape, device=device)
    tuned, source = resolve(key, mode=mode, shape=shape, cache_file=cache_file)
    merge_knobs(tuned, kwargs)
    return tuned.backend, tuned, source


def tune(
    key: TuneKey,
    rule: Rule | str | None = None,
    *,
    shape: tuple[int, int] | None = None,
    board: np.ndarray | None = None,
    backend_set=None,
    trials: int = 3,
    steps: int | None = None,
    warmup_steps: int | None = None,
    dry_run: bool = False,
    save: bool = True,
    cache_file=None,
    measure=None,
    on_trial=None,
) -> TuneResult:
    """The write path: search the candidate space for ``key``, persist the
    winner.  ``dry_run`` ranks by the cost model alone (no device touched,
    nothing persisted) — the CI smoke path.

    The trial board defaults to a seeded random board of ``shape`` (the
    key's bucket when unset), so tuning needs no input files and a re-tune
    measures the identical workload.
    """
    if rule is None:
        rule = key.rule_name
    if isinstance(rule, str):
        rule = get_rule(rule)
    shape = tuple(shape) if shape is not None else key.shape_bucket
    candidates = enumerate_candidates(key, backend_set=backend_set, shape=shape)
    if dry_run:
        results = [
            TrialResult(c, cost_model.estimate_cost(key, c)) for c in candidates
        ]
        best = cost_model.choose(key, candidates)
        return TuneResult(key, results, best, "cost_model", None)
    if board is None:
        board = runner.make_trial_board(key, shape)
    results = run_trials(
        key,
        candidates,
        board,
        rule,
        trials=trials,
        steps=steps,
        warmup_steps=warmup_steps,
        measure=measure,
        on_trial=on_trial,
    )
    win = best_result(results)
    if win is None:
        errors = "; ".join(
            f"{r.config.describe()}: {r.error}" for r in results[:4]
        )
        raise RuntimeError(
            f"every candidate failed for {key.id()} — first errors: {errors}"
        )
    saved = None
    if save:
        cache.put(
            key,
            win.config,
            source="measured",
            seconds_per_step=win.seconds_per_step,
            trials=trials,
            path=cache_file,
        )
        saved = str(cache.cache_path(cache_file))
    return TuneResult(key, results, win.config, "measured", saved)
