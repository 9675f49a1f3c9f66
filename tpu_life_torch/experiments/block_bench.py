"""Kernel K5 alone: k clamped Conway steps of a square int8 board per pass.

The port's counterpart of ``experiments/pallas_bench.py`` (its ``run``):
the same ``key=value`` arguments, the same board
(``np.random.default_rng(0).integers(0, 2, (n, n), int8)``), the same check
and the same report line::

    python -m tpu_life_torch.experiments.block_bench n=8192 bh=256 k=8 outer=10 check=1

It runs 2 launches of ``k`` steps and holds the board to the numpy oracle's
``run_np(board, conway, 2k)``, printing ``correct after <2k> steps:
True|False`` (a wrong board exits 1); then it times ``outer`` launches and
prints ``n=… bh=… k=…: <ms> ms/step  <cells/s> cells/s``.  It runs on the
card (kernel K5); ``device=cpu`` asks for the plain PyTorch version.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from tpu_life_torch.kernels.conway_block import check_domain, conway_block
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops.reference import run_np


def _multi(x: torch.Tensor, bh: int, k: int, outer: int) -> torch.Tensor:
    """``outer`` launches, each fed the last one's board (the experiment's
    ``lax.scan``); on the card they ping-pong between ``x`` and one spare
    board, so ``x`` is overwritten."""
    spare = torch.empty_like(x)
    for _ in range(outer):
        x, spare = conway_block(x, bh, k, out=spare), x
    return x


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(n=8192, bh=256, k=8, outer=10, check=True, device=None) -> bool:
    """The experiment; returns whether the board was right (True when
    ``check`` is off).  ``device`` None is the card."""
    check_domain(n, bh, k)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device=cpu for the plain version")
        device = "cuda"
    device = torch.device(device)
    rng = np.random.default_rng(0)
    board = rng.integers(0, 2, size=(n, n), dtype=np.int8)
    x = torch.from_numpy(board).to(device)

    small = 2
    y = _multi(x.clone(), bh, k, small)
    _sync(device)
    if check:
        expect = run_np(board, get_rule("conway"), small * k)
        got = y.cpu().numpy()
        ok = np.array_equal(got, expect)
        print(f"correct after {small * k} steps: {ok}", flush=True)
        if not ok:
            diff = np.argwhere(got != expect)
            print("first diffs:", diff[:5], "of", len(diff))
            return False

    _sync(device)
    t0 = time.perf_counter()
    y = _multi(x, bh, k, outer)
    _sync(device)
    dt = time.perf_counter() - t0
    steps = outer * k
    print(f"n={n} bh={bh} k={k}: {dt / steps * 1e3:.3f} ms/step  "
          f"{steps * n * n / dt:.3e} cells/s")
    return True


def main(argv: list[str]) -> int:
    kw = dict(arg.split("=", 1) for arg in argv)
    device = kw.pop("device", None)
    return 0 if run(**{key: int(v) for key, v in kw.items()}, device=device) else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
