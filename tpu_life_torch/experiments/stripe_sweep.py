"""Kernels K1 and K3 alone: device time per launch across depths and boards.

Times one launch of ``k`` substeps through the public wrappers
(``packed_stripe.packed_multi_step`` with ``block_steps=k``, and
``sharded_stripe.sharded_stripe_block`` on one shard of a row-sharded
board), by the profiler's kernel records, and holds each launch's output to
the plain PyTorch version first.  It uses nothing but those wrappers, so
the same file runs against any tree of the port that has them::

    python -m tpu_life_torch.experiments.stripe_sweep            # every case
    python -m tpu_life_torch.experiments.stripe_sweep small      # 1500x500 only

Each case prints one JSON line ``{"kernel", "rule", "shape", "k", "ms"}``
(``ms``: mean device time of one launch); a board that differs from the
plain version exits 1.  It runs on the card only.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from tpu_life_torch.kernels import packed_stripe as ps
from tpu_life_torch.kernels import sharded_stripe as k3
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.parallel import halo

REF = (1500, 500)  # the reference contract's board
FULL = (16384, 16384)
R2 = "R2,C2,S2..4,B2..3,NN"
R1 = "R1,C2,S2..3,B3,NN"
# (rule, board, depths): K1 launches
K1_CASES = (
    ("conway", REF, (1, 2, 3, 4, 5, 8, 12, 16, 32)),
    ("conway", FULL, (1, 2, 3, 5, 8, 12, 16, 17, 24, 32)),
    ("highlife", FULL, (8,)),
    (R2, REF, (1, 5, 8, 16)),
    (R2, FULL, (1, 2, 5, 8, 12, 16)),
    (R1, REF, (1, 5, 8, 32)),
    (R1, FULL, (1, 5, 8, 12, 32)),
)
# (rule, board, shards, depth): one K3 launch on the second shard
K3_CASES = (
    ("conway", FULL, 4, 8),
    ("conway:T", FULL, 4, 8),
    ("conway", REF, 4, 8),
    ("conway", REF, 4, 4),
    (R2, REF, 4, 8),
)


def _words(shape: tuple[int, int], rng: np.random.Generator, device: torch.device) -> torch.Tensor:
    board = rng.integers(0, 2, size=shape, dtype=np.int8)
    return torch.from_numpy(bitlife.pack_np(board).view(np.int32).copy()).to(device)


def _device_ms(launch, reps: int) -> float:
    """Mean device time of one call of ``launch``, from the profiler's
    records of the K1 and K3 kernels."""
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if "packed_" in e.name or "sharded_" in e.name]
    if not us:
        raise RuntimeError("the profiler recorded no K1 or K3 kernel")
    return sum(us) / len(us) / 1e3


def _reps(shape: tuple[int, int]) -> int:
    return 20 if shape[0] * shape[1] > 1 << 24 else 200


def k1_case(rule_name: str, shape: tuple[int, int], k: int, rng, device) -> float:
    rule = get_rule(rule_name)
    x = _words(shape, rng, device)
    y = torch.empty_like(x)
    got = ps.packed_multi_step(x.clone(), rule, shape, k, block_steps=k, scratch=y)
    if not torch.equal(got, ps.packed_multi_step_plain(x, rule, shape, k)):
        print(f"K1 {rule_name} {shape} k={k}: differs from the plain version", flush=True)
        sys.exit(1)
    a, b = x.clone(), torch.empty_like(x)
    return _device_ms(lambda: ps.packed_multi_step(a, rule, shape, k, block_steps=k, scratch=b),
                      _reps(shape))


def k3_case(rule_name: str, shape: tuple[int, int], shards: int, k: int, rng, device) -> float:
    rule = get_rule(rule_name)
    h, w = shape
    hl = -(-h // shards)
    fr = halo.halo_depth(rule, k)
    board = _words((hl * shards, w), rng, device)
    board[h:] = 0
    chunks = list(board.split(hl))
    tops, bots = halo.exchange_rows(chunks, fr, periodic=rule.boundary == "torus")
    top, chunk, bot, row0 = tops[1], chunks[1], bots[1], hl - fr
    out = torch.empty_like(chunk)
    got = k3.sharded_stripe_block(top, chunk, bot, row0, rule, shape, k, out=out)
    if not torch.equal(got, k3.sharded_stripe_block_plain(top, chunk, bot, row0, rule, shape, k)):
        print(f"K3 {rule_name} {shape}/{shards} k={k}: differs from the plain version", flush=True)
        sys.exit(1)
    return _device_ms(
        lambda: k3.sharded_stripe_block(top, chunk, bot, row0, rule, shape, k, out=out),
        _reps((hl, w)),
    )


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("stripe_sweep times the CUDA kernels: no CUDA device")
    small = "small" in argv
    device = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    for rule_name, shape, ks in K1_CASES:
        if small and shape != REF:
            continue
        for k in ks:
            ms = k1_case(rule_name, shape, k, rng, device)
            print(json.dumps({"kernel": "K1", "rule": rule_name, "shape": list(shape), "k": k,
                              "ms": round(ms, 5)}), flush=True)
    for rule_name, shape, shards, k in K3_CASES:
        if small and shape != REF:
            continue
        ms = k3_case(rule_name, shape, shards, k, rng, device)
        print(json.dumps({"kernel": "K3", "rule": rule_name, "shape": list(shape),
                          "shards": shards, "k": k, "ms": round(ms, 5)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
