"""Kernels K1, K3 and K5 alone: device time per launch across depths and boards.

Times one launch of ``k`` substeps through the public wrappers
(``packed_stripe.packed_multi_step`` with ``block_steps=k``,
``sharded_stripe.sharded_stripe_block`` on one shard of a row-sharded
board, and ``conway_block.conway_block`` on an int8 board), by the
profiler's kernel records, and holds each launch's output to the plain
PyTorch version first.  It uses nothing but those wrappers, so the same
file runs against any tree of the port that has them::

    python -m tpu_life_torch.experiments.stripe_sweep            # every case
    python -m tpu_life_torch.experiments.stripe_sweep small      # 1500x500 only
    python -m tpu_life_torch.experiments.stripe_sweep k5_tiles   # K5 at every tile

Each case prints one JSON line ``{"kernel", "rule", "shape", "k", "ms"}``
(``ms``: mean device time of one launch); a board that differs from the
plain version exits 1.  ``k5_tiles`` times K5 at every tile shape that
fits a block (``tiles``: output rows and rows a warp), through the C entry
with the tile forced; it needs a tree whose K5 takes its tiles from the
caller.  It runs on the card only.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from tpu_life_torch.kernels import conway_block as k5
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
# (side, bh, depths): K5 launches on a square int8 Conway board; 1000 takes
# 8-byte loads and a partial last word
K5_CASES = (
    (8192, 256, (1, 2, 4, 8, 16, 32)),
    (16384, 256, (1, 2, 4, 8, 16, 32)),
    (1000, 200, (8,)),
)
K5_TILE_SIDES = (8192, 16384)
K5_TILE_DEPTHS = (1, 2, 4, 8, 16, 32)


def _words(shape: tuple[int, int], rng: np.random.Generator, device: torch.device) -> torch.Tensor:
    board = rng.integers(0, 2, size=shape, dtype=np.int8)
    return torch.from_numpy(bitlife.pack_np(board).view(np.int32).copy()).to(device)


def _device_ms(launch, reps: int, names: tuple[str, ...] = ("packed_", "sharded_")) -> float:
    """Mean device time of one call of ``launch``, from the profiler's
    records of the kernels whose names hold one of ``names``."""
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    for _ in range(2):  # now and then a profile holds no kernel records: take one more
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                launch()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events() if any(s in e.name for s in names)]
        if us:
            return sum(us) / len(us) / 1e3
    raise RuntimeError(f"the profiler recorded no kernel named like {names}")


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


def k5_case(n: int, bh: int, k: int, rng, device) -> float:
    x = torch.from_numpy(rng.integers(0, 2, size=(n, n), dtype=np.int8)).to(device)
    if not torch.equal(k5.conway_block(x, bh, k), k5.conway_block_plain(x, k)):
        print(f"K5 {n}^2 k={k}: differs from the plain version", flush=True)
        sys.exit(1)
    bufs = [x, torch.empty_like(x)]

    def launch():
        bufs.reverse()
        k5.conway_block(bufs[1], bh, k, out=bufs[0])

    return _device_ms(launch, _reps((n, n)), ("conway_",))


def k5_tile_cases(n: int, k: int, rng, device) -> list[tuple[int, int, float]]:
    """``(tile_rows, warp_rows, ms)`` of K5 at every tile of 4, 8, 16 or 32
    warps of 4 or 8 rows that leaves an output row, each held to the plain
    version first."""
    x = torch.from_numpy(rng.integers(0, 2, size=(n, n), dtype=np.int8)).to(device)
    want = k5.conway_block_plain(x, k)
    fn = ps._library().conway_block_int8
    y = torch.empty_like(x)
    out = []
    for warp_rows in (ps.SMALL_WARP_ROWS, ps.LARGE_WARP_ROWS):
        for warps in (4, 8, 16, ps.TILE_WARPS):
            rows = warps * warp_rows - 2 * k
            if rows < 1:
                continue

            def launch(src, dst, rows=rows, warp_rows=warp_rows):
                err = fn(src.data_ptr(), dst.data_ptr(), n, k, rows, warp_rows,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"conway_block_int8 failed: CUDA error {err}")

            launch(x, y)
            if not torch.equal(y, want):
                print(f"K5 {n}^2 k={k} tiles {rows}x{warp_rows}: differs from the plain version",
                      flush=True)
                sys.exit(1)

            bufs = [x.clone(), y]

            def pingpong(launch=launch, bufs=bufs):
                bufs.reverse()
                launch(bufs[1], bufs[0])

            out.append((rows, warp_rows, _device_ms(pingpong, _reps((n, n)), ("conway_",))))
    return out


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("stripe_sweep times the CUDA kernels: no CUDA device")
    small = "small" in argv
    device = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    if "k5_tiles" in argv:
        for n in K5_TILE_SIDES:
            for k in K5_TILE_DEPTHS:
                for rows, warp_rows, ms in k5_tile_cases(n, k, rng, device):
                    print(json.dumps({"kernel": "K5", "rule": "conway", "shape": [n, n], "k": k,
                                      "tiles": [rows, warp_rows], "ms": round(ms, 5)}), flush=True)
        return
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
    if small:
        return
    for n, bh, ks in K5_CASES:
        for k in ks:
            ms = k5_case(n, bh, k, rng, device)
            print(json.dumps({"kernel": "K5", "rule": "conway", "shape": [n, n], "k": k,
                              "ms": round(ms, 5)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
