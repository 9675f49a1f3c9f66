"""Kernels K1, K3, K5, K6, K7 and their batch modes alone: device time per launch across depths and boards.

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
    python -m tpu_life_torch.experiments.stripe_sweep k1_tiles   # K1's Moore mode at every tile
    python -m tpu_life_torch.experiments.stripe_sweep ab         # three cases, three times
    python -m tpu_life_torch.experiments.stripe_sweep k6         # the stochastic tier's readings
    python -m tpu_life_torch.experiments.stripe_sweep k1b        # K1's batch mode a chunk at a time
    python -m tpu_life_torch.experiments.stripe_sweep mcb        # the batch modes of K6 and K7

Each case prints one JSON line ``{"kernel", "rule", "shape", "k", "ms"}``
(``ms``: mean device time of one launch); a board that differs from the
plain version exits 1.  ``k5_tiles`` times K5 at every tile shape that
fits a block (``tiles``: output rows and rows a warp), through the C entry
with the tile forced; it needs a tree whose K5 takes its tiles from the
caller.  ``k1_tiles`` times K1's Moore mode the same way at every tile of
2 to 32 warps of 4, 8 or 16 rows (``tiles``: output rows, rows a warp,
warps; ``blocks``: the grid) on boards from 1500x500 to 16384^2; it needs
a tree whose Moore mode takes 16 rows a warp (8 warps at most); a case
the profiler records no kernel of twice prints ``ms`` null.  ``ab``
times K1 (16384^2), a K3 shard (16384^2 on 4) and K5 (8192^2), Conway at
k = 8, three times in turn: the cases a change to the tiles K1, K3 and K5
share must leave as they were, for a parent tree and a change run in one
call.  ``k6`` reads what a change to kernel K6 must
move or leave: a 16384^2 Ising board (seeded, seed 1) through 256 sweeps
of the ``cuda`` Runner at T = 2.27 (host clock, spin updates/s); K6's
device time on that board and on the seeded 4096^2 board of seed 1 (parity
0, sweep 256, held to the plain version first), each with the cells a draw
decides and the bound they give; K7's on a 16384^2 block; and ``bench
--mc`` at 4096^2 and 16384^2 (a child process each).  Run it as a file
from the root of the tree to measure (``PYTHONPATH=. python
<this file> k6``), so that a parent tree and a change are read by the same
code.  ``k1b`` reads what a change to K1's batch mode must move or leave:
the device time of one serving chunk (16 steps, every slot stepping, the
sum of its launches' kernel records) on 8 random boards of 512^2 and of
4096^2 Conway, through the tree's own chunk (``packed_batch.chunk_plan``
where the tree has it, else launches of depth 8), held to the plain
version first, beside the bound of a chunk; where the tree can force the
tiles (``packed_batch.launch``), the same chunk at each tile tried at
512^2 and one launch at depths 1 to 32; the serve mix of ``chip_smoke.py``
phase 16 (b) (32 sessions of 512^2 Conway x 128 steps, capacity 8, chunk
16) through ``serve --serve-backend cuda`` under each pump, seven times,
each result equal to the numpy oracle's bytes (sessions/s, the
device-idle share and K1 batch launches a chunk); then the controls of the
``ab`` mode, three times in turn.  Run it as a file from each tree's root, like ``k6``.  ``mcb``
reads what a change to the batch modes of K6 and K7 must move or leave: K6's batch mode on a
half-sweep of 8 x 4096^2 (the seeded board of ``sweep --seed 7`` in every slot, the sweep's 8
temperatures, parity 0) and K7's on 8 x 1024^2 draws, each held to its plain version first,
with its device time, the cells a draw decides (K6), the bound and the share of it; 8
single-board launches of K6 and of K7 on the same boards and counters; K6 alone at 16384^2
(after 256 sweeps) and on the seeded 4096^2 board, K7 alone at 16384^2, the controls a change
that leaves K6 and K7 as they are must leave within 2%; and ``sweep --size 4096 --steps 256
--temps 1.5:3.0:8 --seed 7`` in process, its ``elapsed_s`` and the launches of each kernel it
took.  Run it as a file from each tree's root, like ``k6``.  Every mode runs on the card only.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

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
    ("highlife", REF, (1, 4, 8, 16, 32)),
    ("highlife", FULL, (1, 4, 8, 16, 32)),
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
# the ab mode's rounds of (K1, K3, K5) readings
AB_ROUNDS = 3
# the k6 mode: the Runner's sweeps at T = 2.27 (near Onsager's 2.269), the
# boards K6 is timed on, and bench --mc's two readings (chip_smoke.py's)
K6_SWEEPS, K6_TEMP = 256, 2.27
K6_SIDES = (4096, 16384)
MC_BENCHES = (["--mc-sizes", "64,128"],
              ["--mc-size", "16384", "--mc-steps", "100", "--mc-base-steps", "20", "--mc-sizes", "64"])
# K6's bound (chip_smoke.py phase 15): a decided cell's word 0 and 2 more
# integer ops (the select of its table entry and one compare), 18 logic ops
# a word; 64 integer-pipe results a clock an SM, 128 over both pipes
ACCEPT_OPS, K6_WORD_OPS, INT_OPS_PER_CLOCK_PER_SM = 2, 18, 64
K5_TILE_SIDES = (8192, 16384)
# the mcb mode: the sweep's batch (8 slots of MCB_SIDE^2, seed 7, the grid
# 1.5:3.0:8, 256 sweeps), K7's batch mode at MCB_ROLL_SIDE^2 (the --no-bitpack sweep's)
MCB_SLOTS, MCB_SIDE, MCB_ROLL_SIDE, MCB_SEED, MCB_STEPS = 8, 4096, 1024, 7, 256
MCB_TEMPS = "1.5:3.0:8"
# the k1b mode: 8 slots of these sides (the serve mix's and a wide board),
# a chunk of 16 steps; Conway's 15 logic ops a word a step (the bound)
K1B_SIDES, K1B_SLOTS, K1B_CHUNK = (512, 4096), 8, 16
K1B_DEPTHS = (1, 2, 4, 8, 16, 32)
K1B_SESSIONS, K1B_STEPS, K1B_REPEATS = 32, 128, 7
# the 512^2 tiles tried at k = 16: (output rows a block, rows a segment)
K1B_TILES = ((32, 4), (32, 8), (32, 2), (16, 2), (8, 2), (64, 4), (64, 2), (16, 4))
K5_TILE_DEPTHS = (1, 2, 4, 8, 16, 32)
# the k1_tiles mode: (board, depths) of K1's Moore mode timed at every tile
# of K1_TILE_WARPS warps of each instance's rows that leaves an output row
K1_TILE_CASES = (
    ("conway", FULL, (1, 2, 3, 4, 5, 8, 12, 16, 24, 32)),
    ("highlife", FULL, (8,)),
    ("conway", (12288, 12288), (8,)),
    ("conway", (8192, 8192), (1, 8, 32)),
    ("conway", (6144, 6144), (8,)),
    ("conway", (4096, 4096), (1, 8, 32)),
    ("conway", (3072, 3072), (8,)),
    ("conway", (2048, 2048), (1, 8, 32)),
    ("conway", (1024, 1024), (8,)),
    ("conway", (16384, 2048), (8,)),
    ("conway", (2048, 16384), (8,)),
    ("conway", REF, (1, 2, 4, 8, 16, 32)),
)
K1_TILE_WARPS = (2, 3, 4, 5, 6, 7, 8, 10, 12, 16, 20, 24, 32)


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


def k1_tile_cases(shape: tuple[int, int], k: int, rng, device, rule_name: str = "conway"):
    """``(tile_rows, warp_rows, warps, blocks, ms)`` of K1's Moore mode at
    every tile of :data:`K1_TILE_WARPS` warps (as many as the instance
    takes) of ``packed_stripe.MOORE_WARP_ROWS`` rows that leaves an output row (the tile's rows less its halo, at most the
    board's), through the C entry with the tile forced, each held to the
    plain version first."""
    rule = get_rule(rule_name)
    h, w = shape
    x = _words(shape, rng, device)
    nwords = x.shape[1]
    want = ps.packed_multi_step_plain(x, rule, shape, k)
    fn = ps._library().packed_stripe_multi_step
    sop = ps.cached_sop_table(rule)
    y = torch.empty_like(x)
    out = []
    seen = set()
    for warp_rows in ps.MOORE_WARP_ROWS:
        for warps in K1_TILE_WARPS:
            if warps > ps.moore_max_warps(warp_rows):
                continue
            rows = min(warps * warp_rows - 2 * k, h)
            if rows < 1 or (rows, warp_rows) in seen:
                continue
            seen.add((rows, warp_rows))

            def launch(src, dst, rows=rows, warp_rows=warp_rows):
                err = fn(src.data_ptr(), dst.data_ptr(), h, nwords, w % 32, k, rows, warp_rows,
                         int(ps.compiled_rule(rule)), ctypes.byref(sop),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"packed_stripe_multi_step failed: CUDA error {err}")

            launch(x, y)
            if not torch.equal(y, want):
                print(f"K1 {rule_name} {shape} k={k} tiles {rows}x{warp_rows}: differs from the "
                      "plain version", flush=True)
                sys.exit(1)
            bufs = [x.clone(), torch.empty_like(x)]

            def pingpong(launch=launch, bufs=bufs):
                bufs.reverse()
                launch(bufs[1], bufs[0])

            blocks = ps.moore_blocks(k, h, nwords, rows, warp_rows)[0]
            try:
                ms = _device_ms(pingpong, _reps(shape))
            except RuntimeError:  # no kernel records twice: not measured
                ms = None
            out.append((rows, warp_rows, -(-(rows + 2 * k) // warp_rows), blocks, ms))
    return out


def decided_cells(x: torch.Tensor, side: int) -> int:
    """The active cells of parity 0 on the packed square board ``x`` (int32
    words of a ``side``^2 torus) whose move a draw decides (dE > 0): the
    draws K6 needs at sweep parity 0."""
    from tpu_life_torch.mc import packed

    s = torch.from_numpy(packed.unpack_board(x.cpu().numpy().view(np.uint32), side)).to(x.device)
    s = s.to(torch.int32) * 2 - 1
    nsum = s.roll(1, 0) + s.roll(-1, 0) + s.roll(1, 1) + s.roll(-1, 1)
    rows = torch.arange(side, device=x.device)
    on = ((rows[:, None] + rows[None, :]) & 1) == 0
    return int((((s * nsum + 4) >> 1 >= 3) & on).sum())


def _chunk_device_ms(launch, reps: int, names: tuple[str, ...]) -> tuple[float, int]:
    """Device time of one call of ``launch`` (the sum of its kernel
    records) and the records a call, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                launch()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events() if any(s in e.name for s in names)]
        if us:
            return sum(us) / reps / 1e3, len(us) // reps
    raise RuntimeError(f"the profiler recorded no kernel named like {names}")


def k1b_cases(device: torch.device, rng) -> list[dict]:
    """The k1b mode's readings, one dict a JSON line."""
    from tpu_life_torch.kernels import packed_batch as kb

    rule = get_rule("conway")
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    planned = hasattr(kb, "chunk_plan")
    out = []
    for side in K1B_SIDES:
        shape = (side, side)
        x = torch.from_numpy(rng.integers(-2**31, 2**31, (K1B_SLOTS, side, side // 32),
                                          dtype=np.int64).astype(np.int32)).to(device)
        steps = torch.full((K1B_SLOTS,), K1B_CHUNK, dtype=torch.int32, device=device)
        bufs = [torch.empty_like(x), torch.empty_like(x)]
        if planned:
            depths = [(lc.k, lc.offset) for lc in kb.chunk_plan(rule, shape, K1B_CHUNK, K1B_SLOTS, sms)]
        else:
            k = ps.clamp_block_steps(rule, 8)
            depths = [(min(k, K1B_CHUNK - o), o) for o in range(0, K1B_CHUNK, k)]

        def chunk(step):
            src = x
            for i, (k, offset) in enumerate(depths):
                src = step(src, bufs[i % 2], k, offset)
            return src

        plain = chunk(lambda s, o, k, off: kb.packed_batch_multi_step_plain(
            s, steps, rule, shape, k, out=o.clone(), offset=off)).clone()
        words = x.numel()
        bound = ps.logic_ops_per_word_step(rule) * words * K1B_CHUNK / (
            INT_OPS_PER_CLOCK_PER_SM * sms * clock) * 1e3
        layouts = [("plan", None)]
        if hasattr(kb, "launch") and side == K1B_SIDES[0]:
            layouts += [(f"tiles of {rows} rows, {r} a segment", kb.Tiles(rows, r, 16))
                        for rows, r in K1B_TILES]
        for name, forced in layouts:
            if forced is None:
                def step(s, o, k, off):
                    return kb.packed_batch_multi_step(s, steps, rule, shape, k, out=o, offset=off)
            else:
                def step(s, o, k, off, tiles=forced):
                    kb.launch(s, steps, rule, shape, k, out=o, offset=off, tiles=tiles)
                    return o
            try:
                got = chunk(step)
            except RuntimeError as e:
                out.append({"kernel": "K1 batch", "layout": name, "shape": [K1B_SLOTS, *shape],
                            "refused": str(e)})
                continue
            if not torch.equal(got, plain):
                print(f"K1 batch {name} 8x{side}^2: differs from the plain version", flush=True)
                sys.exit(1)
            ms, records = _chunk_device_ms(lambda: chunk(step), 50, ("packed_batch",))
            out.append({"kernel": "K1 batch", "layout": name, "shape": [K1B_SLOTS, *shape],
                        "chunk": K1B_CHUNK, "launches": records, "ms": round(ms, 5),
                        "bound_ms": round(bound, 6), "of_bound": round(bound / ms, 4)})
        if hasattr(kb, "launch") and side == K1B_SIDES[0]:
            for k in K1B_DEPTHS:
                tiles = kb.launch_tiles(rule, k, K1B_SLOTS, side, side // 32, sms)

                def one(k=k, tiles=tiles):
                    kb.launch(x, steps, rule, shape, k, out=bufs[0], offset=0, tiles=tiles)

                ms, _ = _chunk_device_ms(one, 50, ("packed_batch",))
                out.append({"kernel": "K1 batch", "layout": "plan's tiles, one launch",
                            "shape": [K1B_SLOTS, *shape], "k": k, "tiles": list(tiles),
                            "ms": round(ms, 5)})
        del x, bufs
        torch.cuda.empty_cache()
    out += serve_mix_cases()
    for _ in range(AB_ROUNDS):
        for kernel, shape, case in (
                ("K1", FULL, lambda: k1_case("conway", FULL, 8, rng, device)),
                ("K3", FULL, lambda: k3_case("conway", FULL, 4, 8, rng, device)),
                ("K5", (8192, 8192), lambda: k5_case(8192, 256, 8, rng, device))):
            out.append({"kernel": kernel, "rule": "conway", "shape": list(shape), "k": 8,
                        "ms": round(case(), 5)})
    return out


def serve_mix_cases() -> list[dict]:
    """The serve mix under each pump, K1B_REPEATS runs: one dict a pump."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from tpu_life_torch import cli
    from tpu_life_torch.io.codec import encode_board, write_board
    from tpu_life_torch.kernels import packed_batch as kb
    from tpu_life_torch.mc.prng import seeded_board
    from tpu_life_torch.ops.reference import run_np
    from tpu_life_torch.serve.engine import BatchEngine

    side, rule = K1B_SIDES[0], get_rule("conway")
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        oracle = []
        for i in range(8):
            board = seeded_board(side, side, seed=100 + i)
            write_board(tmp / f"b{i}.txt", board)
            oracle.append(encode_board(run_np(board, rule, K1B_STEPS)))
        spool = tmp / "mix.jsonl"
        spool.write_text("".join(json.dumps({
            "input_file": str(tmp / f"b{i % 8}.txt"), "height": side, "width": side,
            "steps": K1B_STEPS, "rule": "conway", "seed": 0}) + "\n" for i in range(K1B_SESSIONS)))
        for pump in ("pipelined", "sync"):
            runs = []
            for rep in range(K1B_REPEATS):
                res = tmp / f"out_{pump}_{rep}"
                kb.packed_batch_multi_step.launches = BatchEngine.dispatched = 0
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(["serve", "--requests", str(spool), "--output-dir", str(res),
                                   "--serve-backend", "cuda", "--capacity", "8", "--chunk-steps",
                                   "16", "--max-queue", str(K1B_SESSIONS // 2),
                                   *(["--sync-pump"] if pump == "sync" else [])])
                summary = json.loads(buf.getvalue().strip().splitlines()[-1])
                if rc != 0 or any((res / f"s{i:06d}.txt").read_bytes() != oracle[i % 8]
                                  for i in range(K1B_SESSIONS)):
                    print(f"serve mix {pump}: rc {rc} or a result differs from the numpy oracle",
                          flush=True)
                    sys.exit(1)
                el = summary["elapsed_s"]
                runs.append((summary["sessions_per_sec"], summary["device_idle_s"] / el,
                             kb.packed_batch_multi_step.launches / BatchEngine.dispatched))
            sps, idle, per = (sorted(v) for v in zip(*runs))
            mid = K1B_REPEATS // 2
            out.append({"serve_mix": pump, "runs": K1B_REPEATS,
                        "sessions_per_s": [sps[mid], sps[0], sps[-1]],
                        "device_idle_share": [idle[mid], idle[0], idle[-1]],
                        "launches_per_chunk": per[mid]})
    return out


def _clock_and_sms(device: torch.device) -> tuple[float, int]:
    """The card's max SM clock (Hz, ``nvidia-smi``) and its SMs."""
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.split()[0]) * 1e6
    return clock, torch.cuda.get_device_properties(device).multi_processor_count


def k6_bound_ms(decided: int, words: int, clock: float, sms: int) -> float:
    """K6's bound (chip_smoke.py phase 15): each decided cell's draw and
    accept on the integer pipe, 18 logic ops a word, at 64 a clock an SM
    (its adds at 128 over both pipes bind less)."""
    from tpu_life_torch.kernels import mc_threefry as mct

    alu_ops = decided * (mct.ALU_OPS_PER_DRAW + ACCEPT_OPS) + words * K6_WORD_OPS
    all_ops = decided * (mct.OPS_PER_DRAW + ACCEPT_OPS) + words * K6_WORD_OPS
    return max(alu_ops / INT_OPS_PER_CLOCK_PER_SM,
               all_ops / (2 * INT_OPS_PER_CLOCK_PER_SM)) / (sms * clock) * 1e3


def k7_bound_ms(draws: int, clock: float, sms: int) -> float:
    """K7's bound: word 0's integer-pipe ops a draw at 64 a clock an SM (the
    4 bytes a draw writes bind less)."""
    from tpu_life_torch.kernels import mc_threefry as mct

    return draws * mct.ALU_OPS_PER_DRAW / INT_OPS_PER_CLOCK_PER_SM / (sms * clock) * 1e3


def k6_single(x: torch.Tensor, side: int, board: str, clock: float, sms: int) -> dict:
    """K6 alone on the packed board ``x`` (parity 0, sweep 256, T = 2.27),
    held to its plain version first: device ms, decided cells, bound."""
    from tpu_life_torch.kernels import mc_threefry as mct
    from tpu_life_torch.mc import ising

    thr = ising.acceptance_thresholds(K6_TEMP)
    args = (0, 1, 0, K6_SWEEPS, int(thr[3]), int(thr[4]))
    y = torch.empty_like(x)
    if not torch.equal(mct.packed_metropolis_half(x, *args, width=side, out=y),
                       mct.packed_metropolis_half_plain(x, *args, width=side)):
        print(f"K6 {side}^2: differs from the plain version", flush=True)
        sys.exit(1)
    ms = _device_ms(lambda: mct.packed_metropolis_half(x, *args, width=side, out=y),
                    20 if side > 4096 else 200, ("packed_metropolis_half_kernel",))
    decided = decided_cells(x, side)
    bound_ms = k6_bound_ms(decided, x.numel(), clock, sms)
    return {"kernel": "K6", "shape": [side, side], "board": board, "ms": ms, "decided": decided,
            "active": side * side // 2, "bound_ms": bound_ms, "of_bound": bound_ms / ms}


def k6_cases(device: torch.device) -> list[dict]:
    """The k6 mode's readings, one dict a JSON line."""
    from tpu_life_torch.backends.base import get_backend, make_runner
    from tpu_life_torch.kernels import mc_threefry as mct
    from tpu_life_torch.mc import packed, prng
    from tpu_life_torch.models.rules import get_rule

    clock, sms = _clock_and_sms(device)
    full = K6_SIDES[-1]
    board = prng.seeded_board(full, full, seed=1, device=device).cpu().numpy()
    runner = make_runner(get_backend("cuda", device=device), board, get_rule("ising"), seed=1,
                         temperature=K6_TEMP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.advance(K6_SWEEPS)
    runner.sync()
    secs = time.perf_counter() - t0
    out = [{"runner": "mc_packed", "shape": [full, full], "sweeps": K6_SWEEPS, "seconds": secs,
            "spin_updates_per_sec": full * full * K6_SWEEPS / secs}]
    for side in K6_SIDES:
        x = (runner.x if side == full else torch.from_numpy(packed.pack_board(
            prng.seeded_board(side, side, seed=1, device=device).cpu().numpy()).view(np.int32).copy())
            .to(device))
        out.append(k6_single(x, side, f"after {K6_SWEEPS} sweeps" if side == full else
                             "seeded, seed 1", clock, sms))
    del runner, x
    torch.cuda.empty_cache()
    ms = _device_ms(lambda: mct.cell_uniforms((full, full), 1, 0, 3, prng.SUB_EVEN, device=device),
                    10, ("cell_uniforms_kernel",))
    out.append({"kernel": "K7", "shape": [full, full], "ms": ms})
    for flags in MC_BENCHES:
        proc = subprocess.run([sys.executable, "-m", "tpu_life_torch", "bench", "--mc", *flags],
                              capture_output=True, text=True, check=True, timeout=600)
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        out.append({"bench": "--mc " + " ".join(flags), "size": rec["size"],
                    "mc_sweeps_per_sec": rec["value"],
                    "spin_updates_per_sec": rec["spin_updates_per_sec"]})
    return out


def mcb_cases(device: torch.device) -> list[dict]:
    """The mcb mode's readings, one dict a JSON line."""
    import contextlib
    import io
    import tempfile

    from tpu_life_torch import cli
    from tpu_life_torch.backends.base import get_backend, make_runner
    from tpu_life_torch.kernels import mc_threefry as mct
    from tpu_life_torch.mc import ising, packed, prng
    from tpu_life_torch.models.rules import get_rule

    clock, sms = _clock_and_sms(device)
    side, n = MCB_SIDE, MCB_SLOTS
    lo, hi, count = (float(v) for v in MCB_TEMPS.split(":"))
    temps = [lo + (hi - lo) * i / (count - 1) for i in range(int(count))]
    thr = np.stack([ising.acceptance_thresholds(t) for t in temps])
    k0, k1 = prng.key_halves(MCB_SEED)

    def i32(values) -> torch.Tensor:
        return torch.tensor([prng.as_i32(v) for v in values], dtype=torch.int32, device=device)

    def state(budget: int) -> prng.SlotState:
        return prng.SlotState(i32([k0] * n), i32([k1] * n), i32([0] * n),
                              torch.from_numpy(thr.view(np.int32).copy()).to(device),
                              i32([budget] * n))

    board = prng.seeded_board(side, side, seed=MCB_SEED, device=device).cpu().numpy()
    one = torch.from_numpy(packed.pack_board(board).view(np.int32).copy()).to(device)
    x = one.expand(n, *one.shape).contiguous()
    y = torch.empty_like(x)
    st = state(MCB_STEPS)
    for parity in (0, 1):
        if not torch.equal(mct.packed_metropolis_half_batch(x, parity, st, width=side, out=y),
                           mct.packed_metropolis_half_batch_plain(x, parity, st, width=side)):
            print(f"K6's batch mode {n} x {side}^2: differs from the plain version", flush=True)
            sys.exit(1)
    batch_ms = _device_ms(lambda: mct.packed_metropolis_half_batch(x, 0, st, width=side, out=y),
                          20, ("packed_metropolis_batch_kernel",))

    def k6_singles():
        for s in range(n):
            mct.packed_metropolis_half(x[s], 0, k0, k1, 0, int(thr[s, 3]), int(thr[s, 4]),
                                       width=side, out=y[s])
    singles_ms, _ = _chunk_device_ms(k6_singles, 10, ("packed_metropolis_half_kernel",))
    decided = n * decided_cells(one, side)
    bound_ms = k6_bound_ms(decided, x.numel(), clock, sms)
    out = [{"kernel": "K6 batch", "shape": [n, side, side], "ms": batch_ms, "decided": decided,
            "bound_ms": bound_ms, "of_bound": bound_ms / batch_ms, "singles_ms": singles_ms}]
    del x, y
    roll = (MCB_ROLL_SIDE, MCB_ROLL_SIDE)
    rst = state(32)
    for substream in (prng.SUB_EVEN, prng.SUB_ODD):
        if not torch.equal(mct.cell_uniforms_batch(roll, rst, substream),
                           mct.cell_uniforms_batch_plain(roll, rst, substream)):
            print(f"K7's batch mode {n} x {roll}: differs from the plain version", flush=True)
            sys.exit(1)
    batch_ms = _device_ms(lambda: mct.cell_uniforms_batch(roll, rst, prng.SUB_EVEN), 20,
                          ("cell_uniforms_batch_kernel",))

    def k7_singles():
        for _ in range(n):
            mct.cell_uniforms(roll, k0, k1, 0, prng.SUB_EVEN, device=device)
    singles_ms, _ = _chunk_device_ms(k7_singles, 10, ("cell_uniforms_kernel",))
    bound_ms = k7_bound_ms(n * roll[0] * roll[1], clock, sms)
    out.append({"kernel": "K7 batch", "shape": [n, *roll], "ms": batch_ms, "bound_ms": bound_ms,
                "of_bound": bound_ms / batch_ms, "singles_ms": singles_ms})
    torch.cuda.empty_cache()
    # the controls: K6 and K7 alone
    full = K6_SIDES[-1]
    big = prng.seeded_board(full, full, seed=1, device=device).cpu().numpy()
    runner = make_runner(get_backend("cuda", device=device), big, get_rule("ising"), seed=1,
                         temperature=K6_TEMP)
    runner.advance(K6_SWEEPS)
    runner.sync()
    out.append(k6_single(runner.x, full, f"after {K6_SWEEPS} sweeps", clock, sms))
    del runner
    small = K6_SIDES[0]
    seeded = torch.from_numpy(packed.pack_board(prng.seeded_board(
        small, small, seed=1, device=device).cpu().numpy()).view(np.int32).copy()).to(device)
    out.append(k6_single(seeded, small, "seeded, seed 1", clock, sms))
    torch.cuda.empty_cache()
    ms = _device_ms(lambda: mct.cell_uniforms((full, full), 1, 0, 3, prng.SUB_EVEN, device=device),
                    10, ("cell_uniforms_kernel",))
    out.append({"kernel": "K7", "shape": [full, full], "ms": ms,
                "of_bound": k7_bound_ms(full * full, clock, sms) / ms})
    torch.cuda.empty_cache()
    # the sweep in process: its elapsed_s and the launches it took
    counters = (mct.packed_metropolis_half_batch, mct.cell_uniforms_batch,
                mct.packed_metropolis_half, mct.cell_uniforms)
    with tempfile.TemporaryDirectory() as tmp:
        for fn in counters:
            fn.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["sweep", "--size", str(side), "--steps", str(MCB_STEPS), "--temps",
                           MCB_TEMPS, "--seed", str(MCB_SEED), "--output-dir", tmp,
                           "--device", str(device)])
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or rec["done"] != n:
        print(f"sweep: exit {rc}, {rec.get('done')} sessions done", flush=True)
        sys.exit(1)
    out.append({"sweep": f"--size {side} --steps {MCB_STEPS} --temps {MCB_TEMPS}",
                "elapsed_s": rec["elapsed_s"], "rounds": rec["rounds"],
                "launches": {fn.__name__: fn.launches for fn in counters}})
    return out


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("stripe_sweep times the CUDA kernels: no CUDA device")
    small = "small" in argv
    device = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    if "k6" in argv:
        for rec in k6_cases(device):
            print(json.dumps(rec), flush=True)
        return
    if "mcb" in argv:
        for rec in mcb_cases(device):
            print(json.dumps(rec), flush=True)
        return
    if "k1b" in argv:
        for rec in k1b_cases(device, rng):
            print(json.dumps(rec), flush=True)
        return
    if "ab" in argv:
        for _ in range(AB_ROUNDS):
            cases = (("K1", FULL, lambda: k1_case("conway", FULL, 8, rng, device)),
                     ("K3", FULL, lambda: k3_case("conway", FULL, 4, 8, rng, device)),
                     ("K5", (8192, 8192), lambda: k5_case(8192, 256, 8, rng, device)))
            for kernel, shape, case in cases:
                print(json.dumps({"kernel": kernel, "rule": "conway", "shape": list(shape), "k": 8,
                                  "ms": round(case(), 5)}), flush=True)
        return
    if "k1_tiles" in argv:
        for rule_name, shape, ks in K1_TILE_CASES:
            for k in ks:
                for rows, warp_rows, warps, blocks, ms in k1_tile_cases(shape, k, rng, device,
                                                                         rule_name):
                    print(json.dumps({"kernel": "K1", "rule": rule_name, "shape": list(shape),
                                      "k": k, "tiles": [rows, warp_rows, warps],
                                      "blocks": blocks,
                                      "ms": None if ms is None else round(ms, 5)}), flush=True)
        return
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
