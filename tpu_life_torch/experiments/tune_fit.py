"""The autotuner on the card: trial spread, tune tables and the cost model's fit.

Measures what ``autotune/runner.py`` and ``autotune/cost_model.py`` take
from the card, and prints one JSON line a reading (all of them are also
written to ``chiprun_out/tune_fit.json``)::

    python -m tpu_life_torch.experiments.tune_fit          # everything
    python -m tpu_life_torch.experiments.tune_fit spread   # the trial spread only

- ``spread``: seven timed trials of ``runner._measure`` (``advance`` then
  ``runner.sync()`` on the host clock) at 16, 64 and 256 steps, for
  ``cuda`` (K1) and ``sharded`` with ``local_kernel="cuda"`` (K3) at k = 8
  on random Conway boards of 4096^2 and 16384^2: the median s/step and the
  spread, (max - min) / median, from which ``runner.TRIAL_STEPS_CUDA``
  is chosen (its comment gives the reading).
- ``tune``: ``autotune.tune`` (nothing saved) at 16384^2 Conway over every
  candidate of the card (``torch``, ``sharded`` with both local kernels,
  ``cuda``, each over ``BLOCK_STEPS_GRID``), 5 trials of 256 steps; the
  stencil axis of ``torch`` on ``bugs`` at 8192^2 and on ``lenia:orbium`` at
  2048^2 (3 trials of 8 steps).
- ``fit``: the cost model's constants from those tables (:func:`fit`), the
  model's pick against the measured winner, and the ratio of their
  measured s/step.

It runs on the card only (the ``cuda`` candidates need it).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

OUT = Path("chiprun_out")
SPREAD_STEPS = (16, 64, 256)


def fit(cuda_sps: dict[int, float], sharded_cuda: dict[int, float],
        sharded_torch: dict[int, float], stencil: dict[str, tuple[float, float]]) -> dict:
    """The cost model's constants from measured s/step.

    - COMPUTE, TRAFFIC, FRINGE: least squares of ``cuda``'s s/step over k
      (radius 1), divided by the series' minimum, against ``1, 1/k, k``; a
      coefficient that fits negative is dropped (0) and the rest refitted.
    - CUDA_FACTOR: the median over k of ``cuda_sps / sharded_torch``.
    - KERNEL_FACTOR: the median over k of ``sharded_cuda / sharded_torch``.
    - MATMUL_WIDE / MATMUL_NARROW: ``stencil["wide"]`` and
      ``stencil["narrow"]``, each ``(matmul s/step, roll s/step)``.
    """
    ks = sorted(cuda_sps)
    lo = min(cuda_sps.values())
    y = np.array([cuda_sps[k] / lo for k in ks])
    cols = {"COMPUTE": np.ones(len(ks)), "TRAFFIC": np.array([1.0 / k for k in ks]),
            "FRINGE": np.array([float(k) for k in ks])}
    kept = list(cols)
    dropped: list[str] = []
    while True:
        a = np.stack([cols[n] for n in kept], axis=1)
        coef, *_ = np.linalg.lstsq(a, y, rcond=None)
        neg = [n for n, c in zip(kept, coef) if c < 0]
        if not neg:
            break
        worst = min(zip(kept, coef), key=lambda t: t[1])[0]
        kept.remove(worst)
        dropped.append(worst)
    out = {n: 0.0 for n in cols}
    out.update({n: float(c) for n, c in zip(kept, coef)})
    def over_plain(series):
        return float(statistics.median(series[k] / sharded_torch[k] for k in sorted(series)
                                       if k in sharded_torch))

    out["CUDA_FACTOR"] = over_plain(cuda_sps)
    out["KERNEL_FACTOR"] = over_plain(sharded_cuda)
    out["MATMUL_WIDE"] = float(stencil["wide"][0] / stencil["wide"][1])
    out["MATMUL_NARROW"] = float(stencil["narrow"][0] / stencil["narrow"][1])
    out["dropped"] = dropped
    out["residual_max"] = float(np.max(np.abs(
        sum(out[n] * cols[n] for n in cols) - y)))
    return out


def _emit(rows: list, rec: dict) -> None:
    rows.append(rec)
    print(json.dumps(rec), flush=True)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()


def spread(rows: list) -> None:
    from tpu_life_torch.autotune import runner
    from tpu_life_torch.autotune.space import TunedConfig
    from tpu_life_torch.models.rules import get_rule

    rule = get_rule("conway")
    for n in (4096, 16384):
        board = np.random.default_rng(0).integers(0, 2, size=(n, n), dtype=np.int8)
        for cfg in (TunedConfig("cuda", 8), TunedConfig("sharded", 8, "cuda")):
            for steps in SPREAD_STEPS:
                med, samples = runner._measure(cfg, board, rule, steps=steps, warmup_steps=16,
                                               trials=7)
                _emit(rows, {"reading": "spread", "size": n, "config": cfg.describe(),
                             "steps": steps, "median_s_per_step": med,
                             "spread": (max(samples) - min(samples)) / med,
                             "samples": samples})


def _table(key, rule, shape, **kw) -> list:
    from tpu_life_torch import autotune

    res = autotune.tune(key, rule, shape=shape, save=False, **kw)
    return res.results


def tune_tables(rows: list) -> dict:
    from tpu_life_torch import autotune
    from tpu_life_torch.models.rules import get_rule

    tables = {}
    for name, n, kw in (
        ("conway", 16384, dict(trials=5, steps=256, warmup_steps=16)),
        ("bugs", 8192, dict(trials=3, steps=8, warmup_steps=2, backend_set=("torch",))),
        ("lenia:orbium", 2048, dict(trials=3, steps=8, warmup_steps=2)),
    ):
        rule = get_rule(name)
        key = autotune.tune_key_for(rule, (n, n))
        t0 = time.perf_counter()
        results = _table(key, rule, (n, n), **kw)
        for r in results:
            _emit(rows, {"reading": "tune", "rule": name, "size": n, "key": key.id(),
                         "config": r.config.to_dict(), "describe": r.config.describe(),
                         "s_per_step": r.seconds_per_step, "samples": r.samples,
                         "error": r.error})
        _emit(rows, {"reading": "tune_seconds", "rule": name,
                     "seconds": time.perf_counter() - t0})
        tables[name] = (key, results)
    return tables


def fit_from_tables(rows: list, tables: dict) -> dict:
    from tpu_life_torch.autotune import cost_model

    _, conway = tables["conway"]

    def series(backend, kernel):
        return {r.config.block_steps: r.seconds_per_step for r in conway
                if r.ok and r.config.backend == backend
                and (kernel is None or r.config.local_kernel == kernel)}

    def stencil_pair(name):
        _, res = tables[name]
        by = {r.config.stencil: r.seconds_per_step for r in res if r.ok}
        return by["matmul"], by["roll"]

    constants = fit(series("cuda", None), series("sharded", "cuda"),
                    series("sharded", "torch"),
                    {"wide": stencil_pair("lenia:orbium"), "narrow": stencil_pair("bugs")})
    _emit(rows, {"reading": "fit", **constants})
    # the cost model's pick under the fitted constants, against the winner
    for n in ("COMPUTE", "TRAFFIC", "FRINGE", "CUDA_FACTOR", "KERNEL_FACTOR", "MATMUL_WIDE",
              "MATMUL_NARROW"):
        setattr(cost_model, n, constants[n])
    for name, (key, res) in tables.items():
        ok = [r for r in res if r.ok]
        best = min(ok, key=lambda r: r.seconds_per_step)
        pick = cost_model.choose(key, [r.config for r in res])
        pick_sps = next(r.seconds_per_step for r in res if r.config == pick)
        _emit(rows, {"reading": "pick", "rule": name, "best": best.config.describe(),
                     "best_s_per_step": best.seconds_per_step,
                     "model_pick": pick.describe(), "model_pick_s_per_step": pick_sps,
                     "pick_over_best": None if pick_sps is None
                     else pick_sps / best.seconds_per_step})
    return constants


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_fit: no CUDA device", file=sys.stderr)
        return 1
    rows: list = []
    _emit(rows, {"reading": "card", "nvidia_smi": _card(),
                 "cpus": os.cpu_count()})
    spread(rows)
    if "spread" not in argv:
        tables = tune_tables(rows)
        fit_from_tables(rows, tables)
    OUT.mkdir(exist_ok=True)
    (OUT / "tune_fit.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
