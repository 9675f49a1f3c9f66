#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``tpu_life_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. probe — a CUDA device must be present; prints its name and
   ``nvidia-smi``'s name and power limit;
2. build — compiles the kernel sources of the main paths from
   ``tpu_life_torch/csrc`` (one nvcc each, started together, at first use),
   prints the build seconds and each ptxas report; for every instance of
   K1 and K3 (Moore with Conway's rule compiled in and with the rule as
   data, clamped and on the torus, and the diamonds at radius 1 and 2),
   of K5 (built with them, at 4 and 8 rows a warp) and for K2 and K4 it
   prints the registers and fails on spill stores or loads; it counts
   ``LOP3``, ``SHF``, ``SHFL``, ``LDS``, ``STS``, ``BAR`` and all
   instructions in each K1, K3 and K5 instance's SASS and the shared-memory
   loads, stores and asynchronous copies (``LDS``, ``STS``, ``LDGSTS``) in
   K2's and K4's (``cuobjdump -sass`` on the built libraries);
3. kernel vs plain — holds each kernel bit-identical (``torch.equal``) to
   its plain PyTorch version on the card (K3 and K4 below the list): K1
   over Conway (its compiled rule) and three life-like rules it runs as
   data (``highlife``, ``day_and_night``, ``seeds``), ragged shapes up to
   16384^2, widths with W % 32 of 0, 1 and 31, a board whose live cells
   touch all four edges, and depths 1, 2, 8 and 32, each with a remainder
   launch; K1's diamond
   mode over three von Neumann rules (r = 1, r = 2, r = 2 with the centre),
   shapes from 11x11 to 16384^2, widths with W % 32 of 0, 1 and 31, a
   board whose live cells touch all four edges, and depths 1, 2, 8 and the
   clamp (32 / r), each with a remainder launch; K2 over six
   clamped Moore rules (life-like, Generations, Larger-than-Life with and
   without the centre), shapes from 11x11 to 8192^2, block depths 1, 8 and
   32 as the radius clamp allows, each with a remainder launch, boards
   whose live cells touch all four edges, and wide radii up to the largest
   the kernel runs (127 with 2 states, the byte lanes' limit; 123 with 10,
   shared memory's), with tiles shrunk to fit, with 16- and 8-byte copies.
   The two routes that have no kernel in either package (the packed torus
   step and the int8 stencil, plain PyTorch ops on the card) are held to
   the numpy oracle at 257x1000;
4. main paths — ``python -m tpu_life_torch run`` on the reference workload
   (1500x500, 100 steps), in process with every launch count set to 0 just
   before and read just after, then as a subprocess; and ``run
   --no-bitpack`` in process, which must go through K2 and not K1.  Every
   output.txt must have the golden sha256 and 751,500 bytes.  Then ``run
   --rule R2,C2,S2..4,B2..3,NN``, which must take route ``k1_diamond`` with
   13 diamond launches, and ``run --rule conway:T``, route ``packed_torus``
   with no launch; each output must equal the numpy oracle's bytes;
5. full size, K1 — a 16384^2 Conway board for 256 steps through the
   ``cuda`` backend's Runner, held to the plain version; then its cell
   updates per second through the Runner (host clock, delta timing), and
   the kernel timed with CUDA events against its plain version and its
   bound; at 16384^2 and at the reference's 1500x500 also its device time
   from the profiler's kernel records, with the tiles ``tile_shape`` picks;
   and ``highlife`` (a rule the kernel runs as data) at 16384^2 beside
   Conway;
6. full size, K2 — ``bugs`` (R5) at 8192^2 and ``brians_brain`` (C3) at
   16384^2 through the Runner, each held to the plain version after its
   steps, with cell updates per second through the Runner; then K2 timed
   at both shapes with CUDA events and the profiler's kernel records,
   against its plain version and its bound; and its device time at the
   reference's 1500x500 (``conway`` at k = 8 as ``--no-bitpack`` runs it,
   ``bugs`` at k = 1) from the profiler's kernel records;
7. full size, von Neumann and torus — ``R2,C2,S2..4,B2..3,NN`` at 16384^2
   for 256 steps through the Runner (K1's diamond mode), held to the plain
   version; ``conway:T`` at 16384^2 (packed torus ops, held to the int8
   torus ops on the same board) and ``R2,C2,S2..4,B2..3,NN:T`` and
   ``brians_brain:T`` at 8192^2 (int8 stencil ops, held to the torus's
   translation symmetry); cell updates per second through the Runner for
   all four; the diamond mode timed at 16384^2 (r = 2 and r = 1) and at
   1500x500 with CUDA events and the profiler's kernel records, against
   its plain version and its bound; the two ops routes' ms per step;
8. the sharded backend at full size — a 16384^2 Conway board for 256
   steps on 4 shards of the one card (route ``k3``: kernel K3 per shard),
   held to phase 5's K1 result on the same board, with 128 K3 launches
   and 192 halo copies; its cell updates per second through the Runner;
   one shard's K3 launch (4096 x 512 words, k = 8) timed with CUDA events
   and the profiler's kernel records against its plain version, its bound
   and K1's launch over the whole board; the halo exchange and one block
   timed; then ``conway:T`` 16384^2 on 4 shards through ``k3_torus``,
   held to the ``packed_torus`` ops on the same board, with its ms per
   step beside phase 7's;
9. the sharded backend at full size on 2-D meshes — ``bugs`` 8192^2 for 64
   steps on 4 row shards and on 2x2 shards of the card and ``brians_brain``
   16384^2 for 64 steps on 2x2 (route ``k4``: kernel K4 per shard, k = 1
   and 8), each held to phase 6's K2 result on the same board, with its
   launches and row and column halo copies counted and its cell updates
   per second through the Runner; one shard's K4 launch timed with CUDA
   events and the profiler's kernel records against its plain version,
   its bound and K2's launch over the whole board; per block the host's
   issue time and the device records (K4, copies, idle share); then
   ``conway`` 16384^2 for 256 steps on 2x2 under ``auto`` (packed plain
   ops, no kernel), held to phase 5's K1 board, and ``conway:T`` 16384^2
   for 32 steps on 2x2 (the 2-D torus: closed rings on both axes, packed
   plain ops), held to phase 7's ``packed_torus`` board;
10. kernel K5 (the int8 Conway block kernel of the experiment) — K5
   bit-identical to its plain version over the TPU kernel's domain (k < bh,
   k = bh, a block and its halos filling the board, (n, n/2, n/4) in one and
   in 32 launches, sides not a multiple of 4 and sides that take 8- and
   4-byte loads, 8192^2 and 16384^2, boards random and with all four edges
   live; boards at byte offsets that take 1-, 4- and 8-byte loads), and to
   K2 running ``conway`` at
   the same k on the same 8192^2 and 16384^2 boards; every shape outside the
   domain refused; ``tpu_life_torch.experiments.block_bench`` at its
   defaults (n=8192, bh=256, k=8, outer=10) in process, with K5's launch
   count set to 0 just before and read just after (2 + 10), and as a
   subprocess, each printing ``correct after 16 steps: True``; K5 timed at
   8192^2 and 16384^2 (k = 8) with CUDA events and the profiler's kernel
   records beside its bound, its plain version and K2's ``conway`` launch
   on the same board, with the tiles ``conway_block.tile_shape`` picks;
11. the seeded-board, ``gen``, ``pattern`` and ``--bug-compat`` paths —
   ``run --size 4096 --steps 256 --seed 7`` (K1) and ``--rule brians_brain
   --steps 64`` (K2), each held to ``--backend torch``'s bytes, and at 512^2
   to ``--backend numpy``'s, with the staging seconds; ``gen --height 1500
   --width 500 --seed 3`` then ``run``; ``pattern import --name
   gosper_glider_gun`` (256^2, 300 steps) then ``run`` and ``pattern
   export``; ``run --bug-compat`` on the reference workload; each in
   process with the K1 and K2 counts set to 0 just before and read just
   after, and each equal to the numpy backend's bytes;
12. the driver's instruments and ``bench`` — the fault drill
   (``--snapshot-every 25 --keep-snapshots 2 --fault-at 60 --max-restarts
   1`` with ``--metrics-file`` and ``--trace-events``) on the reference
   workload through K1, through ``--backend sharded --device cuda:0
   --num-devices 4`` (K3) and through ``--no-bitpack`` (K2): each at the
   golden sha256 with one restart, its route and its launches counted
   (16, 64 and 16), the live count of each chunk equal to the numpy
   oracle's, the trace holding every span of the driver and the newest 2
   snapshots kept; ``--resume`` from a step-50 snapshot at the golden
   sha256; ``--profile``, whose exported trace must name
   ``packed_stripe_kernel`` (once a K1 launch in a fresh process); the
   reference run's ``Total time`` bare, traced and with the instruments
   on, in turns; ``gen`` of a 16384^2 board, then ``run --trace-events``
   on it through K1, held to the plain version, with its host phases
   (stage, drive, gather, output-write) from the trace; ``bench`` at its defaults (4096^2) and at
   16384^2 through ``cuda`` and through ``sharded --device cuda:0
   --num-devices 4 --local-kernel cuda``, each record printed, with
   ``n_chips`` 1; and K1-K4 timed again at phases 5-9's launches (CUDA
   events and profiler device time), beside those phases' readings;
13. the banded-matmul counts and the continuous (Lenia) tier, which no
   kernel runs (those runs' K1-K5 counts must stay 0) — ``run --rule
   lenia:orbium --size 4096 --steps 32 --seed 1`` (``auto``: the ``torch``
   backend, the matmul correlation), its seeded board through both
   stencils on the card (allclose at ``FLOAT_ATOL`` after 8 steps, the
   error at 32 printed), the four known-answer cases through both
   stencils, ms a step by CUDA events beside the dense-band and the
   correlation bounds, the operators' memory and cells/s; ``run --backend
   torch --stencil matmul`` on the reference workload at the golden
   sha256; ``bugs`` 8192^2 x 64 through ``torch --stencil matmul``,
   bit-identical to phase 6's K2 board, timed beside the roll stencil;
   ``auto`` keeping integer rules on roll: ``run --rule bugs --backend
   sharded --num-devices 4`` at 4096^2 takes K4 (its launches counted),
   bit-identical to ``torch``'s roll stencil;
   Lenia on 4 row shards of the card (``--num-devices 4``) allclose to one
   card after 8 steps; ``bugs:T`` 4096^2 x 32 on ``--mesh-shape 2,2
   --stencil matmul`` bit-identical to one card's ``--stencil roll``;
   ``--local-kernel cuda --stencil matmul`` refused; ``bench --rule
   lenia:orbium --size 4096`` (delta of 20 and 4 steps) printing its record.

Phases 2-4 cover K3 too: it is built with K1 (same source, its instances
in the ptxas report and the SASS counts); phase 3 holds it bit-identical to its
plain version (the ``shard_ops`` route on the same mesh) in its three
modes — Moore clamped, diamond (r = 1, 2) clamped, Moore torus — on meshes
of 1, 2, 3, 4 and 8 shards of the card, heights that leave padding rows,
W % 32 of 0, 1 and 31, live cells on all four edges, and depths 1, 2 and
8 with a remainder block; phase 4 runs ``python -m tpu_life_torch run
--backend sharded --num-devices 1`` in process (route ``k3``, 13
launches) and as a subprocess, and ``--device cuda:0 --num-devices 4`` in
process (52 launches, 78 halo copies), each at the golden sha256.

Phases 2-4 cover K4 too: it is built with K2 (same source,
``sharded_int8_kernel``); phase 3 holds it bit-identical to its plain
version (the ``shard_ops`` route on the int8 cells of the same mesh) on
meshes of 1x1, 4x1 (4 row shards), 1x4, 2x2, 2x4, 4x2 and 3x1 shards of
the card, for ``bugs``, ``brians_brain``, ``star_wars``,
``R2,C2,M1,S5..10,B5..8`` and ``conway`` (bitpack off), on boards whose
heights and widths leave padding rows and columns, live cells on all four
edges, and depths 1, 2 and the clamp with a remainder block; phase 4 runs
``python -m tpu_life_torch run --backend sharded --device cuda:0`` with
``--num-devices 4 --no-bitpack`` (route ``k4``, 52 launches, 78 row
copies) and ``--mesh-shape 2,2 --no-bitpack`` (``k4``, 52 launches, 52 row
and 156 column copies) in process, and ``--mesh-shape 2,2`` (``shard_ops``,
no kernel launch), each at the golden sha256.

The line before the last is the kernels record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import base64
import contextlib
import gzip
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
# the port's copy of the reference workload's golden output (conway, 100 steps)
GOLDEN_SHA = "ea69597f6ada6271b4b182c592f36395652fee9cf2d28a2e17c80fb5eca79215"
GOLDEN_BYTES = 751_500
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
INT_OPS_PER_CLOCK_PER_SM = 64  # 32-bit integer/logic results per clock per Hopper SM
FULL = 16384
FULL_STEPS = 256
BLOCK_STEPS = 8
# phase 13: lenia:orbium on one card and on 4 row shards of it
LENIA_SIDE = 4096
LENIA_STEPS = 32
# K2's full-size cells: (rule, side, steps through the Runner)
K2_FULL = [("bugs", 8192, 64), ("brians_brain", 16384, 64)]
K2_RULES = ["conway", "brians_brain", "star_wars", "bugs", "bugs_decay", "R2,C2,M1,S5..10,B5..8"]
K2_SHAPES = [(11, 11), (257, 1000), (1500, 500), (5000, 2000), (8192, 8192)]
# K1's diamond mode: the rules (r = 2, r = 1, r = 2 counting the centre), the
# shapes (the last three have W % 32 of 0, 1 and 31) and the depths asked for
# (the wrapper clamps 32 to 16 at r = 2)
DIAMOND = "R2,C2,S2..4,B2..3,NN"
DIAMOND_R1 = "R1,C2,S2..3,B3,NN"
DIAMOND_RULES = [DIAMOND, DIAMOND_R1, "R2,C2,M1,S3..6,B3..5,NN"]
DIAMOND_SHAPES = [(11, 11), (257, 1000), (1500, 500), (5000, 2000), (300, 992), (300, 993),
                  (300, 1023), (FULL, FULL)]
DIAMOND_DEPTHS = (1, 2, BLOCK_STEPS, 32)
# K1's Moore mode: the depths asked for, each with a remainder launch
K1_DEPTHS = (1, 2, BLOCK_STEPS, 32)
DATA_RULE = "highlife"  # a Moore rule the kernels run as data, timed beside conway
# the instances the kernels record names: each row's shape at k = 8
K1_MAIN = "K1 packed_stripe_kernel<8, ConwayRule>"
K1_DATA = "K1 packed_stripe_kernel<8, DataRule>"
K1_DIAMOND = "K1 packed_diamond_kernel<2, 8>"
K3_MAIN = "K3 sharded_stripe_kernel<false, 8, ConwayRule>"
K1_SMALL = "K1 packed_stripe_kernel<4, ConwayRule>"  # the reference board's tiles
# phase 12's fault drill on the reference workload (100 steps): a snapshot
# every 25 steps, 2 kept, a fault crossing step 60 and one restart
DRILL_EVERY = 25
DRILL = ["--snapshot-every", str(DRILL_EVERY), "--keep-snapshots", "2", "--fault-at", "60",
         "--max-restarts", "1"]
# the driver's spans, each of which a drill's trace must hold (but the
# profile's)
TRACE_SPANS = ("run", "config-resolve", "backend-build", "stage", "drive", "chunk",
               "snapshot-write", "recovery-rewind", "gather", "output-write", "torch-profile")
# the routes with no kernel in either package, held to the numpy oracle
OPS_SHAPE, OPS_STEPS = (257, 1000), 5
OPS_RULES = [("conway:T", "packed_torus"), ("R2,C2,S2..4,B2..3,NN:T", "stencil"),
             ("brians_brain:T", "stencil"), ("R3,C2,S6..10,B6..8,NN", "stencil"),
             ("R1,C3,S1..2,B2,NN", "stencil")]
# their full-size runs: (rule, side, steps through the Runner)
TORUS_FULL = ("conway:T", FULL, 32)
STENCIL_FULL = [("R2,C2,S2..4,B2..3,NN:T", 8192, 8), ("brians_brain:T", 8192, 8)]
# K3 against its plain version: its modes (Moore clamped and torus, the
# diamond at r = 2 and 1), meshes of shards of the one card, widths with
# W % 32 of 0, 1 and 31 (heights 300 leave padding rows on 8 shards; torus
# heights divide by every mesh size), and depths with a remainder block
K3_RULES = ["conway", "conway:T", DIAMOND, DIAMOND_R1]
K3_WIDTHS = (992, 993, 1023)
K3_MESHES = (1, 2, 3, 4, 8)
K3_DEPTHS = (1, 2, BLOCK_STEPS)
# K4 against its plain version: meshes (rows, cols) of shards of the one card
# (a row mesh of 4 and of 3, a row of 4, and 2-D meshes), the rules of the
# int8 route (conway runs with bitpack off), and depths 1, 2 and the clamp
# (8, cut to what the radius allows), each with a remainder block
K4_MESHES = ((1, 1), (4, 1), (1, 4), (2, 2), (2, 4), (4, 2), (3, 1))
K4_RULES = ["bugs", "brians_brain", "star_wars", "R2,C2,M1,S5..10,B5..8", "conway"]
K4_SHAPES = ((301, 517), (40, 1000))  # padding rows and columns on every mesh
K4_DEPTHS = (1, 2, BLOCK_STEPS)
# K5 against its plain version: (n, bh, k) over the TPU kernel's domain: k
# below bh, k = bh (the edge blocks' halos reach the whole next block), a
# block and its halos filling the board, (n, n/2, n/4) at one launch of the
# deepest k and at several launches, sides not a multiple of 4 (byte loads),
# 8- and 4-byte loads (1000 and 996, each with a partial last word), the
# experiment's defaults and the full side
K5_CASES = [(32, 16, 8), (48, 16, 3), (64, 16, 16), (64, 16, 4), (96, 32, 8), (128, 64, 32),
            (512, 256, 128), (4096, 2048, 1024), (9, 3, 1), (45, 15, 5), (999, 333, 33),
            (1000, 200, 37), (996, 332, 33), (8192, 256, 8), (FULL, 512, 8)]
# K5 on a board at these byte offsets into its buffer (n, bh, k = 96, 32,
# 8): loads and stores of 1, 4 and 8 bytes where the side allows 16
K5_OFFSETS = (1, 4, 8)
# shapes outside the domain, which K5 must refuse: bh not dividing n, k past
# bh (the TPU kernel's wrong board), bh + 2k past n (it does not trace), k = 0
# K5 held to K2's conway and timed at these sides
K5_SIDES = (8192, FULL)
K5_REFUSED = [(48, 20, 4), (64, 16, 17), (32, 16, 9), (16, 16, 2), (64, 16, 0)]
# the seeded paths: (rule, side, steps, route, (K1, K2) launches); the 512^2
# runs are held to the numpy backend's bytes, the 4096^2 ones to the torch
# backend's (plain ops on the card)
SEEDED_SIDE = 4096
SEEDED_RUNS = [("conway", SEEDED_SIDE, 256, "k1", (32, 0)), ("brians_brain", SEEDED_SIDE, 64, "k2", (0, 8)),
               ("conway", 512, 256, "k1", (32, 0)), ("brians_brain", 512, 64, "k2", (0, 8))]
# K4 at full size: (rule, side, steps, mesh), each held to phase 6's K2 board
K4_FULL = [("bugs", 8192, 64, (4, 1)), ("bugs", 8192, 64, (2, 2)),
           ("brians_brain", 16384, 64, (2, 2))]
# K2 at wide radii (depth 1), where the tile grows with the halo and then
# shrinks to fit shared memory: widths that are and are not a multiple of 16;
# the largest radii of the kernel before this layout for 2 and for 10 states
# (92 and 61), and the largest now (127: a vertical sum of 2r + 1 cells fills
# a byte; 123: shared memory)
K2_WIDE = [
    ("R60,C2,S1500..9000,B3400..3700", (1024, 1024)),
    ("R50,C2,S1000..6000,B2400..2600", (1024, 1024)),
    ("R50,C2,S1000..6000,B2400..2600", (1024, 1000)),
    ("R60,C2,S1500..9000,B3400..3700", (4096, 4096)),
    ("R92,C2,S3000..20000,B8000..8600", (512, 512)),
    ("R61,C10,S300..3000,B700..780", (512, 512)),
    ("R127,C2,S6000..40000,B16000..17000", (600, 600)),
    ("R123,C10,S1200..12000,B2800..3150", (600, 600)),
]
# the shared-memory instructions counted in K2's and K4's SASS
SASS_OPS = ("LDS", "STS", "LDGSTS")
# the instructions counted in the SASS of every K1, K3 and K5 instance (and
# the total): logic, funnel shifts, shuffles, shared memory and barriers
K1_SASS_OPS = ("LOP3", "SHF", "SHFL", "LDS", "STS", "BAR")
# every kernel instance packed_stripe.cu builds (label, pattern of its
# mangled name): K1 Moore and K3 Moore (clamped, torus) with Conway's rule
# compiled in and with the rule as data, the diamonds at radius 1 and 2,
# and K5, each at 4 and 8 rows a warp
K5_MAIN = "K5 conway_int8_kernel<8>"
STRIPE_INSTANCES = [
    *[(f"K1 packed_stripe_kernel<{n}, {r}Rule>", rf"packed_stripe_kernelILi{n}E\w*{r}Rule")
      for n in (4, 8) for r in ("Conway", "Data")],
    *[(f"K1 packed_diamond_kernel<{rad}, {n}>", rf"packed_diamond_kernelILi{rad}ELi{n}E")
      for rad in (1, 2) for n in (4, 8)],
    *[(f"K3 sharded_stripe_kernel<{t}, {n}, {r}Rule>",
       rf"sharded_stripe_kernelILb{int(t == 'true')}ELi{n}E\w*{r}Rule")
      for t in ("false", "true") for n in (4, 8) for r in ("Conway", "Data")],
    *[(f"K3 sharded_diamond_kernel<{rad}, {n}>", rf"sharded_diamond_kernelILi{rad}ELi{n}E")
      for rad in (1, 2) for n in (4, 8)],
    *[(f"K5 conway_int8_kernel<{n}>", rf"conway_int8_kernelILi{n}E") for n in (4, 8)],
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_report(lib: Path) -> dict[str, tuple[int, int, int]]:
    """(spill store bytes, spill load bytes, registers) of each kernel in
    the ``-Xptxas -v`` report kept beside a built library, by mangled name."""
    report = {}
    for entry in (lib.parent / "build.log").read_text().split("Compiling entry function")[1:]:
        name = re.match(r" '(\w+)'", entry)
        used = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?Used (\d+) registers",
                         entry, re.S)
        if name and used:
            report[name.group(1)] = tuple(map(int, used.groups()))
    return report


def sass_counts_of(lib: Path) -> dict[str, dict[str, int]]:
    """The counts of :data:`K1_SASS_OPS` and all instructions in each
    kernel's SASS (``cuobjdump -sass``), by mangled name."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts = {}
    for m in re.finditer(r"Function : (\w+)\n(.*?)(?=\n\s+Function : |\Z)", sass, re.S):
        ops = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", m.group(2), re.M)
        counts[m.group(1)] = {**{op: sum(o == op for o in ops) for op in K1_SASS_OPS},
                              "total": len(ops)}
    return counts


def main() -> int:
    import torch

    # -- 1. probe -------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    sys.path.insert(0, str(ROOT))
    try:
        import numpy as np

        from tpu_life_torch import cli
        from tpu_life_torch.backends.base import (
            drive_runner,
            get_backend,
            make_runner,
            measure_throughput,
        )
        from tpu_life_torch.io.codec import encode_board, read_board, read_config
        from tpu_life_torch.mc.prng import seeded_board
        from tpu_life_torch.experiments import block_bench
        from tpu_life_torch.kernels import conway_block as k5
        from tpu_life_torch.kernels import int8_tiled as kt
        from tpu_life_torch.kernels import packed_stripe as ps
        from tpu_life_torch.kernels import sharded_int8 as k4
        from tpu_life_torch.kernels import sharded_stripe as k3
        from tpu_life_torch.models.rules import get_rule
        from tpu_life_torch.ops import bitlife, stencil
        from tpu_life_torch.ops.reference import run_np
        from tpu_life_torch.parallel import halo
        from tpu_life_torch.parallel.mesh import make_mesh, make_mesh_2d
        from tpu_life_torch.runtime import driver
    except ImportError as e:
        fail(f"the tpu_life_torch package is not beside this script: {e}")
    if not (FIXTURES / "reference_data.txt.gz").exists():
        fail(f"reference fixture missing under {FIXTURES}")
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    sm_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"max SM clock {sm_clock_mhz} MHz, {n_sm} SMs")
    print(smi, flush=True)

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        libs = list(pool.map(lambda m: m.build(), (ps, kt)))
    ps._library()
    kt._library()
    print(f"build: {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for lib in libs:
        print((lib.parent / "build.log").read_text().strip(), flush=True)
    # K1, K3 and K5 share the tiles: one instance per kernel and (Moore)
    # rule; registers, no spill, and their SASS counts
    k1_report = ptxas_report(libs[0])
    k1_sass = sass_counts_of(libs[0])
    k1_instances = {}
    for label, pattern in STRIPE_INSTANCES:
        names = [n for n in k1_report if re.search(pattern, n)]
        if len(names) != 1:
            fail(f"the ptxas report of packed_stripe.cu names {len(names)} kernels for {label}")
        spill_st, spill_ld, regs = k1_report[names[0]]
        if spill_st or spill_ld:
            fail(f"{label} spills: {spill_st} bytes of stores, {spill_ld} bytes of loads")
        if names[0] not in k1_sass:
            fail(f"cuobjdump -sass of {libs[0].name} does not name {label}")
        k1_instances[label] = dict(registers=regs, sass=k1_sass[names[0]])
    if len(k1_report) != len(STRIPE_INSTANCES):
        fail(f"packed_stripe.cu builds {len(k1_report)} kernels, want {len(STRIPE_INSTANCES)}")
    print(f"K1, K3 and K5 (ptxas, cuobjdump -sass): {len(k1_instances)} instances, no spill; "
          f"registers and SASS ({', '.join(K1_SASS_OPS)}, total):", flush=True)
    for label, inst in k1_instances.items():
        print(f"  {label}: {inst['registers']} registers; "
              + ", ".join(f"{op} {n}" for op, n in inst["sass"].items()), flush=True)
    # K2 and K4 share int8_tile: registers, no spill, and the shared-memory
    # instructions of their SASS
    int8_report = {}
    for name, used in ptxas_report(libs[1]).items():
        short = re.search(r"int8_tiled_kernel|sharded_int8_kernel", name)
        if short:
            int8_report[short.group(0)] = used
    if set(int8_report) != {"int8_tiled_kernel", "sharded_int8_kernel"}:
        fail(f"the ptxas report of int8_tiled.cu names {sorted(int8_report)}, want K2 and K4")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(libs[1])], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    registers, sass_counts = {}, {}
    for kernel, (spill_st, spill_ld, regs) in sorted(int8_report.items()):
        if spill_st or spill_ld:
            fail(f"{kernel} spills: {spill_st} bytes of stores, {spill_ld} bytes of loads")
        body = re.search(rf"Function : \w*{kernel}\w*\n(.*?)(?=\n\s+Function : |\Z)", sass, re.S)
        if body is None:
            fail(f"cuobjdump -sass of {libs[1].name} does not name {kernel}")
        ops = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body.group(1), re.M)
        registers[kernel] = regs
        sass_counts[kernel] = {op: sum(o == op for o in ops) for op in SASS_OPS}
    print("K2 and K4 (ptxas, cuobjdump -sass): " + "; ".join(
        f"{kernel} {registers[kernel]} registers, no spill, SASS "
        + ", ".join(f"{op} {n}" for op, n in sass_counts[kernel].items())
        for kernel in ("int8_tiled_kernel", "sharded_int8_kernel")), flush=True)

    def words(board):
        return torch.from_numpy(bitlife.pack_np(board).view(np.int32).copy()).to(dev)

    def diff_cells(a, b) -> int:
        """Max |cell difference| between two packed boards: 0 or 1."""
        return int(bool((a ^ b).any()))

    # -- 3. kernel vs plain on the card -----------------------------------
    rng = np.random.default_rng(2024)

    # Conway runs the instance with its rule compiled in, the others the
    # rule as data; 5000x2000 and 16384^2 take tall tiles with a ragged last
    # one, the smaller boards short ones (tile_shape) to fill the SMs; 300 x
    # 992, 993 and 1023 have W % 32 of 0, 1 and 31
    rules = ["conway", "highlife", "day_and_night", "seeds"]
    shapes = [(1, 1), (3, 33), (31, 32), (257, 1000), (1500, 500), (300, 992), (300, 993),
              (300, 1023), (5000, 2000), (FULL, FULL)]
    edge = np.zeros((300, 1000), np.int8)  # live cells on all four edges
    edge[:7], edge[-7:], edge[:, :7], edge[:, -7:] = 1, 1, 1, 1
    boards = [(rng.integers(0, 2, size=shape, dtype=np.int8), "random") for shape in shapes]
    max_err = 0
    cases = 0
    t0 = time.perf_counter()
    for board, what in [*boards, (edge, "edge board")]:
        h, w = board.shape
        x0 = words(board)
        for name in rules:
            rule = get_rule(name)
            for k in K1_DEPTHS:
                steps = 5 if k == 1 else 2 * k + 3  # a remainder launch
                want = ps.packed_multi_step_plain(x0, rule, (h, w), steps)
                got = ps.packed_multi_step(x0.clone(), rule, (h, w), steps, block_steps=k)
                torch.cuda.synchronize()
                err = diff_cells(got, want)
                max_err = max(max_err, err)
                cases += 1
                if err:
                    fail(f"kernel != plain: rule {name}, {what} {h}x{w}, k={k}, {steps} steps")
    print(f"kernel vs plain: {cases} cases bit-identical ({time.perf_counter() - t0:.1f} s); "
          f"rules {', '.join(f'{n} ({'compiled' if ps.compiled_rule(get_rule(n)) else 'data'})' for n in rules)}",
          flush=True)

    diamond_max_err = 0
    diamond_cases = 0

    def diamond_case(x0, rule, shape, k, what):
        nonlocal diamond_max_err, diamond_cases
        depth = ps.clamp_block_steps(rule, k)
        steps = 5 if depth == 1 else 2 * depth + 3  # a remainder launch
        before = ps.packed_multi_step.diamond_launches
        want = ps.packed_multi_step_plain(x0, rule, shape, steps)
        got = ps.packed_multi_step(x0.clone(), rule, shape, steps, block_steps=k)
        torch.cuda.synchronize()
        launched = ps.packed_multi_step.diamond_launches - before
        if launched != -(-steps // depth):
            fail(f"diamond mode: {launched} launches for {steps} steps at depth {depth}")
        err = diff_cells(got, want)
        diamond_max_err = max(diamond_max_err, err)
        diamond_cases += 1
        if err:
            fail(f"diamond mode != plain: {what}, {shape[0]}x{shape[1]}, k={k} "
                 f"(depth {depth}), {steps} steps")

    t0 = time.perf_counter()
    for h, w in DIAMOND_SHAPES:
        x0 = words(rng.integers(0, 2, size=(h, w), dtype=np.int8))
        for name in DIAMOND_RULES:
            for k in DIAMOND_DEPTHS:
                diamond_case(x0, get_rule(name), (h, w), k, f"rule {name}")
    # live cells on all four edges: a birth just past an edge must stay dead
    # through every substep, rows and columns both
    edge = np.zeros((300, 1000), np.int8)
    edge[:7], edge[-7:], edge[:, :7], edge[:, -7:] = 1, 1, 1, 1
    for name in DIAMOND_RULES:
        for k in DIAMOND_DEPTHS:
            diamond_case(words(edge), get_rule(name), edge.shape, k, f"edge board, {name}")
    print(f"K1 diamond mode vs plain: {diamond_cases} cases bit-identical "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def cells(board):
        return torch.from_numpy(np.ascontiguousarray(board, np.int8)).to(dev)

    def states_board(shape, rule):
        return (rng.integers(0, rule.states, size=shape, dtype=np.int8)
                * rng.integers(0, 2, size=shape, dtype=np.int8))

    def int8_err(a, b) -> int:
        """Max |state difference| between two int8 boards."""
        return int((a.int() - b.int()).abs().max()) if a.numel() else 0

    k2_max_err = 0
    k2_cases = 0

    def k2_case(x0, rule, shape, k, steps, what):
        nonlocal k2_max_err, k2_cases
        want = kt.int8_multi_step_plain(x0, rule, shape, steps)
        got = kt.int8_multi_step(x0.clone(), rule, shape, steps, block_steps=k)
        torch.cuda.synchronize()
        err = int8_err(got, want)
        k2_max_err = max(k2_max_err, err)
        k2_cases += 1
        if err:
            fail(f"K2 != plain: {what}, {shape[0]}x{shape[1]}, k={k}, {steps} steps")

    t0 = time.perf_counter()
    for h, w in K2_SHAPES:
        for name in K2_RULES:
            rule = get_rule(name)
            x0 = cells(states_board((h, w), rule))
            for k in sorted({kt.clamp_block_steps(rule, k) for k in (1, BLOCK_STEPS, 32)}):
                steps = 5 if k == 1 else 2 * k + 3  # a remainder launch
                k2_case(x0, rule, (h, w), k, steps, f"rule {name}")
    # live cells on all four edges, also at depths past the clamp (bugs at
    # k > 1, brians_brain at 32), where a birth just past a full edge would
    # feed the next substep's counts unless it is pinned dead
    edge = np.zeros((300, 1000), np.int8)
    edge[:7], edge[-7:], edge[:, :7], edge[:, -7:] = 1, 1, 1, 1
    for name, ks in (("bugs", (1, 2, 3)), ("brians_brain", (1, 8, 32)), ("R2,C2,M1,S5..10,B5..8", (4,))):
        for k in ks:
            k2_case(cells(edge), get_rule(name), edge.shape, k, 2 * k + 1, f"edge board, {name}")
    wide = []
    for name, shape in K2_WIDE:
        rule = get_rule(name)
        k = kt.clamp_block_steps(rule, BLOCK_STEPS)
        rows, cols = kt.tile_shape(rule, k, *shape, n_sm)
        k2_case(cells(states_board(shape, rule)), rule, shape, k, 5, f"rule {name}")
        wide.append(f"R{rule.radius} C{rule.states} {shape[0]}x{shape[1]}: {rows}x{cols} "
                    f"tiles, {kt.shared_bytes(rule, k, rows, cols)} B, "
                    f"{kt.io_bytes(shape[1])}-byte copies")
    print(f"K2 vs plain: {k2_cases} cases bit-identical "
          f"({time.perf_counter() - t0:.1f} s); wide radii at k=1: " + "; ".join(wide),
          flush=True)

    # the routes that have no kernel in either package: plain ops on the card,
    # held to the numpy oracle
    t0 = time.perf_counter()
    ops_backend = get_backend("cuda")
    for name, route in OPS_RULES:
        rule = get_rule(name)
        board = states_board(OPS_SHAPE, rule)
        runner = make_runner(ops_backend, board, rule)
        if runner.route != route or not runner.x.is_cuda:
            fail(f"rule {name} took route {runner.route!r} on {runner.x.device}, want {route!r} on the card")
        drive_runner(runner, OPS_STEPS)
        if not np.array_equal(runner.fetch(), run_np(board, rule, OPS_STEPS)):
            fail(f"route {route} != numpy oracle: rule {name}, {OPS_SHAPE}, {OPS_STEPS} steps")
    print(f"ops routes vs numpy oracle: {len(OPS_RULES)} rules equal at "
          f"{OPS_SHAPE[0]}x{OPS_SHAPE[1]}, {OPS_STEPS} steps ({time.perf_counter() - t0:.1f} s): "
          + ", ".join(f"{n} by {r}" for n, r in OPS_RULES), flush=True)

    # K3 against its plain version on the card: the sharded backend's K3
    # route against its shard_ops route (the plain per-shard block) on the
    # same mesh of shards of the one card, chunk for chunk
    k3_max_err = 0
    k3_cases = 0

    def k3_case(board, rule, n, k, what):
        nonlocal k3_max_err, k3_cases
        mesh = make_mesh(devices=[dev] * n)
        kern = make_runner(get_backend("sharded", mesh=mesh, block_steps=k), board, rule)
        plain = make_runner(
            get_backend("sharded", mesh=mesh, block_steps=k, local_kernel="torch"), board, rule)
        if not kern.route.startswith("k3") or plain.route != "shard_ops":
            fail(f"K3 case {what}: routes {kern.route!r} and {plain.route!r}")
        steps = 2 * k + 3  # a remainder block
        before = k3.sharded_stripe_block.launches
        drive_runner(kern, steps)
        drive_runner(plain, steps)
        if k3.sharded_stripe_block.launches == before:
            fail(f"K3 case {what}: no K3 launch")
        err = max(diff_cells(a, b) for a, b in zip(kern.chunks, plain.chunks))
        k3_max_err = max(k3_max_err, err)
        k3_cases += 1
        if err:
            fail(f"K3 != plain: {what}, {board.shape[0]}x{board.shape[1]} on {n} shards, "
                 f"k={k}, {steps} steps")

    t0 = time.perf_counter()
    for name in K3_RULES:
        rule = get_rule(name)
        h = 240 if rule.boundary == "torus" else 300
        boards = [(rng.integers(0, 2, size=(h, w), dtype=np.int8), f"{name}, random")
                  for w in K3_WIDTHS]
        edge = np.zeros((h // 5, 70), np.int8)  # live cells on all four edges
        edge[:5], edge[-5:], edge[:, :5], edge[:, -5:] = 1, 1, 1, 1
        boards.append((edge, f"{name}, edge board"))
        for board, what in boards:
            for n in K3_MESHES:
                for k in K3_DEPTHS:
                    k3_case(board, rule, n, k, what)
    print(f"K3 vs plain: {k3_cases} cases bit-identical on meshes of "
          f"{', '.join(map(str, K3_MESHES))} shards ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # K4 against its plain version on the card: the sharded backend's k4
    # route against its shard_ops route on the int8 cells (the plain
    # per-shard block) on the same mesh of shards of the one card
    k4_max_err = 0
    k4_cases = 0

    def k4_case(board, rule, shape, k, what):
        nonlocal k4_max_err, k4_cases
        mesh = make_mesh_2d(shape, devices=[dev] * (shape[0] * shape[1]))
        kern = make_runner(get_backend("sharded", mesh=mesh, block_steps=k, bitpack=False), board, rule)
        plain = make_runner(get_backend("sharded", mesh=mesh, block_steps=k, bitpack=False,
                                        local_kernel="torch"), board, rule)
        if kern.route != "k4" or plain.route != "shard_ops":
            fail(f"K4 case {what}: routes {kern.route!r} and {plain.route!r}")
        steps = 2 * k + 3  # a remainder block
        before = k4.sharded_int8_block.launches
        drive_runner(kern, steps)
        drive_runner(plain, steps)
        if k4.sharded_int8_block.launches == before:
            fail(f"K4 case {what}: no K4 launch")
        err = max(int8_err(a, b) for a, b in zip(kern.chunks, plain.chunks))
        k4_max_err = max(k4_max_err, err)
        k4_cases += 1
        if err:
            fail(f"K4 != plain: {what}, {board.shape[0]}x{board.shape[1]} on a "
                 f"{shape[0]}x{shape[1]} mesh, k={k}, {steps} steps")

    t0 = time.perf_counter()
    for name in K4_RULES:
        rule = get_rule(name)
        for h, w in K4_SHAPES:
            board = states_board((h, w), rule)
            board[:3], board[-3:], board[:, :3], board[:, -3:] = 1, 1, 1, 1  # all four edges
            for shape in K4_MESHES:
                for k in K4_DEPTHS:
                    k4_case(board, rule, shape, k, f"rule {name}")
    print(f"K4 vs plain: {k4_cases} cases bit-identical on meshes of "
          f"{', '.join(f'{r}x{c}' for r, c in K4_MESHES)} shards ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # -- 4. the main path: the reference contract through the CLI ----------
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with gzip.open(FIXTURES / "reference_data.txt.gz", "rb") as f:
            (tmp / "data.txt").write_bytes(f.read())
        shutil.copy(FIXTURES / "reference_grid_size_data.txt", tmp / "grid_size_data.txt")
        args = ["run", "--config-file", str(tmp / "grid_size_data.txt"),
                "--input-file", str(tmp / "data.txt")]

        def check_output(path: Path, what: str) -> None:
            raw = path.read_bytes()
            sha = hashlib.sha256(raw).hexdigest()
            if len(raw) != GOLDEN_BYTES or sha != GOLDEN_SHA:
                fail(f"{what}: output.txt is {len(raw)} bytes, sha256 {sha}; "
                     f"want {GOLDEN_BYTES} bytes, {GOLDEN_SHA}")

        ps.packed_multi_step.launches = kt.int8_multi_step.launches = 0
        rc = cli.main([*args, "--output-file", str(tmp / "out_inproc.txt")])
        main_launches = ps.packed_multi_step.launches
        k2_in_k1_run = kt.int8_multi_step.launches
        if rc != 0:
            fail(f"in-process run exited {rc}")
        if main_launches <= 0 or k2_in_k1_run:
            fail(f"the reference run launched the packed stripe kernel {main_launches} "
                 f"times and the int8 kernel {k2_in_k1_run} times")
        check_output(tmp / "out_inproc.txt", "in-process run")
        ps.packed_multi_step.launches = kt.int8_multi_step.launches = 0
        rc = cli.main([*args, "--no-bitpack", "--output-file", str(tmp / "out_int8.txt")])
        k2_main_launches = kt.int8_multi_step.launches
        k1_in_k2_run = ps.packed_multi_step.launches
        if rc != 0:
            fail(f"in-process --no-bitpack run exited {rc}")
        if k2_main_launches <= 0 or k1_in_k2_run:
            fail(f"the --no-bitpack run launched the int8 kernel {k2_main_launches} "
                 f"times and the packed stripe kernel {k1_in_k2_run} times")
        check_output(tmp / "out_int8.txt", "in-process --no-bitpack run")

        # the von Neumann and torus paths through the same entry point; each
        # run's RunResult names the route its runner took
        results = []
        real_run = driver.run

        def recording_run(cfg):
            results.append(real_run(cfg))
            return results[-1]

        ref_h, ref_w, ref_steps = read_config(tmp / "grid_size_data.txt")
        ref_board = read_board(tmp / "data.txt", ref_h, ref_w)
        rule_runs = {}
        driver.run = recording_run
        try:
            for name, route in ((DIAMOND, "k1_diamond"), ("conway:T", "packed_torus")):
                out = tmp / f"out_{route}.txt"
                ps.packed_multi_step.launches = ps.packed_multi_step.diamond_launches = 0
                kt.int8_multi_step.launches = 0
                rc = cli.main([*args, "--rule", name, "--output-file", str(out)])
                counts = (ps.packed_multi_step.launches, ps.packed_multi_step.diamond_launches,
                          kt.int8_multi_step.launches)
                if rc != 0:
                    fail(f"in-process run --rule {name} exited {rc}")
                if results[-1].route != route:
                    fail(f"run --rule {name} took route {results[-1].route!r}, want {route!r}")
                # 100 steps at the default depth of 8: 12 launches of 8 and one of 4
                want_counts = (13, 13, 0) if route == "k1_diamond" else (0, 0, 0)
                if counts != want_counts:
                    fail(f"run --rule {name} launched (K1, of them diamond, K2) = {counts}, "
                         f"want {want_counts}")
                if out.read_bytes() != encode_board(run_np(ref_board, get_rule(name), ref_steps)):
                    fail(f"run --rule {name}: output differs from the numpy oracle's bytes")
                rule_runs[route] = counts
        finally:
            driver.run = real_run
        diamond_main_launches = rule_runs["k1_diamond"][1]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_life_torch", *args,
             "--output-file", str(tmp / "output.txt")],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600,
        )
        wall_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"python -m tpu_life_torch run exited {proc.returncode}: {proc.stderr[-2000:]}")
        check_output(tmp / "output.txt", "subprocess run")
        print(f"main path: reference workload at the golden sha256 "
              f"({main_launches} kernel launches); subprocess: "
              f"{proc.stdout.strip().splitlines()[-1]}, {wall_s:.3f} s wall "
              f"clock for the whole process", flush=True)
        print(f"main path --no-bitpack: reference workload at the golden sha256 "
              f"through K2 ({k2_main_launches} K2 launches, {k1_in_k2_run} K1)",
              flush=True)
        print(f"main path --rule {DIAMOND}: reference workload equal to the numpy "
              f"oracle's bytes by route k1_diamond ({diamond_main_launches} diamond "
              f"launches, {rule_runs['k1_diamond'][2]} K2); --rule conway:T: equal by "
              f"route packed_torus (launches K1, diamond, K2: {rule_runs['packed_torus']})",
              flush=True)

        # the sharded backend's main path: one shard (the one card), then
        # four shards of the one card; the reference workload is 12 blocks
        # of 8 steps and one of 4
        sharded_runs = {}
        driver.run = recording_run
        try:
            for n_shards, extra in ((1, []), (4, ["--device", "cuda:0"])):
                out = tmp / f"out_sharded_{n_shards}.txt"
                ps.packed_multi_step.launches = kt.int8_multi_step.launches = 0
                k3.sharded_stripe_block.launches = halo.exchange_rows.copies = 0
                rc = cli.main([*args, "--backend", "sharded", "--num-devices", str(n_shards),
                               *extra, "--output-file", str(out)])
                counts = (k3.sharded_stripe_block.launches, halo.exchange_rows.copies,
                          ps.packed_multi_step.launches, kt.int8_multi_step.launches)
                if rc != 0:
                    fail(f"in-process run --backend sharded --num-devices {n_shards} exited {rc}")
                if results[-1].route != "k3":
                    fail(f"run --backend sharded took route {results[-1].route!r}, want 'k3'")
                want_counts = (13 * n_shards, 13 * 2 * (n_shards - 1), 0, 0)
                if counts != want_counts:
                    fail(f"run --backend sharded --num-devices {n_shards}: (K3 launches, halo "
                         f"copies, K1, K2) = {counts}, want {want_counts}")
                check_output(out, f"in-process run --backend sharded --num-devices {n_shards}")
                sharded_runs[n_shards] = counts
        finally:
            driver.run = real_run
        k3_main_launches = sharded_runs[1][0]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_life_torch", *args, "--backend", "sharded",
             "--num-devices", "1", "--output-file", str(tmp / "output_sharded.txt")],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600,
        )
        sharded_wall_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"python -m tpu_life_torch run --backend sharded exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        check_output(tmp / "output_sharded.txt", "subprocess run --backend sharded")
        print(f"main path --backend sharded --num-devices 1: reference workload at the golden "
              f"sha256 by route k3 ({k3_main_launches} K3 launches, {sharded_runs[1][1]} halo "
              f"copies, K1 and K2 {sharded_runs[1][2:]}); subprocess: "
              f"{proc.stdout.strip().splitlines()[-1]}, {sharded_wall_s:.3f} s wall clock; "
              f"--device cuda:0 --num-devices 4: golden sha256, {sharded_runs[4][0]} K3 "
              f"launches, {sharded_runs[4][1]} halo copies", flush=True)

        # K4's main path: the reference workload on the int8 cells, 4 row
        # shards and 2x2 shards of the card (13 blocks of 4 launches), then
        # 2x2 with bitpack on, which keeps a 2-D mesh's life-like rules on
        # the packed plain ops (no kernel)
        k4_runs = {}
        driver.run = recording_run
        try:
            for what, extra, route in (
                ("--num-devices 4 --no-bitpack", ["--num-devices", "4", "--no-bitpack"], "k4"),
                ("--mesh-shape 2,2 --no-bitpack", ["--mesh-shape", "2,2", "--no-bitpack"], "k4"),
                ("--mesh-shape 2,2", ["--mesh-shape", "2,2"], "shard_ops"),
            ):
                out = tmp / f"out_k4_{len(k4_runs)}.txt"
                ps.packed_multi_step.launches = kt.int8_multi_step.launches = 0
                k3.sharded_stripe_block.launches = k4.sharded_int8_block.launches = 0
                halo.exchange_rows.copies = halo.exchange_cols.copies = 0
                rc = cli.main([*args, "--backend", "sharded", "--device", "cuda:0", *extra,
                               "--output-file", str(out)])
                counts = (k4.sharded_int8_block.launches, halo.exchange_rows.copies,
                          halo.exchange_cols.copies, k3.sharded_stripe_block.launches,
                          ps.packed_multi_step.launches, kt.int8_multi_step.launches)
                if rc != 0:
                    fail(f"in-process run --backend sharded {what} exited {rc}")
                if results[-1].route != route:
                    fail(f"run --backend sharded {what} took route {results[-1].route!r}, "
                         f"want {route!r}")
                if what.startswith("--num-devices"):
                    want_counts = (52, 13 * 6, 0, 0, 0, 0)
                elif route == "k4":
                    want_counts = (52, 13 * 4, 13 * 12, 0, 0, 0)
                else:
                    want_counts = (0, 13 * 4, 13 * 12, 0, 0, 0)
                if counts != want_counts:
                    fail(f"run --backend sharded {what}: (K4 launches, row copies, column "
                         f"copies, K3, K1, K2) = {counts}, want {want_counts}")
                check_output(out, f"in-process run --backend sharded {what}")
                k4_runs[what] = counts
        finally:
            driver.run = real_run
        k4_main_launches = k4_runs["--num-devices 4 --no-bitpack"][0]
        print("main path, K4: reference workload at the golden sha256 by " + "; ".join(
            f"{what} (K4 launches, row copies, column copies, K3, K1, K2) = {c}"
            for what, c in k4_runs.items()), flush=True)

    # -- 5. full size through the cuda backend -----------------------------
    rule = get_rule("conway")
    board = rng.integers(0, 2, size=(FULL, FULL), dtype=np.int8)
    backend = get_backend("cuda", block_steps=BLOCK_STEPS)
    runner = make_runner(backend, board, rule)
    x0 = runner.x.clone()
    ps.packed_multi_step.launches = 0
    t0 = time.perf_counter()
    drive_runner(runner, FULL_STEPS)
    drive_s = time.perf_counter() - t0
    full_launches = ps.packed_multi_step.launches
    if full_launches <= 0:
        fail("the full-size run launched the packed stripe kernel 0 times")
    want = ps.packed_multi_step_plain(x0, rule, (FULL, FULL), FULL_STEPS)
    err = diff_cells(runner.x, want)
    max_err = max(max_err, err)
    if err:
        fail(f"full-size run != plain after {FULL_STEPS} steps")
    k1_board, k1_final = board, runner.x.clone()  # phase 8 holds the sharded run to it
    live = runner.live_count()
    if live != int(bitlife.live_count_packed(want)) or live <= 0:
        fail(f"full-size live count {live} disagrees with the plain version")
    print(f"full size: {FULL}^2 x {FULL_STEPS} steps through the cuda backend "
          f"({full_launches} launches, {drive_s:.3f} s host clock incl. first "
          f"launch) equal to plain; live cells {live}", flush=True)
    runner_cells_per_s, _ = measure_throughput(backend, board, rule, FULL_STEPS, FULL_STEPS // 4)
    print(f"cell_updates_per_sec_per_chip {runner_cells_per_s:.6e} ({FULL}^2 conway "
          f"through the Runner, host clock, delta of {FULL_STEPS} and "
          f"{FULL_STEPS // 4} steps)", flush=True)

    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def pingpong(step, x):
        """One launch per call of ``step(src, scratch)``, ping-ponging two
        buffers."""
        bufs = [x, torch.empty_like(x)]

        def launch():
            out = step(bufs[0], bufs[1])
            if out is not bufs[0]:
                bufs[0], bufs[1] = out, bufs[0]

        return launch

    conway = rule

    random_words = {}  # one random packed board per shape, made on the host once

    def launcher(shape, k: int, rule=conway):
        """One k-step K1 launch per call, from a copy of a random board."""
        if shape not in random_words:
            random_words[shape] = words(rng.integers(0, 2, size=shape, dtype=np.int8))
        return pingpong(
            lambda a, b: ps.packed_multi_step(a, rule, shape, k, block_steps=k, scratch=b),
            random_words[shape].clone())

    def kernel_ms(shape, k: int, reps: int, rule=conway) -> float:
        return cuda_ms(launcher(shape, k, rule), reps)

    def profiled_ms(launch, kernel: str, reps: int) -> float | None:
        """Mean time of one launch on the device, from the profiler's
        kernel records: free of the host's gaps between launches.  None
        where the profiler records no kernel."""
        from torch.profiler import ProfilerActivity, profile

        launch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                launch()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events() if kernel in e.name]
        return sum(us) / len(us) / 1e3 if us else None

    def device_breakdown(launch, reps: int, kernel: str | None = None) -> dict | None:
        """Per call of ``launch``, from the profiler's device records: the
        ms of kernels and of copies (memcpys; with ``kernel`` named, every
        record but that kernel's, which takes in the strided copies of the
        column halos), and the span from the first device record's start
        to the last one's end; the rest of the span is the card's idle
        share.  None where the profiler records nothing on the device."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        launch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                launch()
            torch.cuda.synchronize()
        recs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not recs:
            return None
        copies = sum(e.time_range.elapsed_us() for e in recs
                     if ("Memcpy" in e.name if kernel is None else kernel not in e.name))
        busy = sum(e.time_range.elapsed_us() for e in recs)
        span = max(e.time_range.end for e in recs) - min(e.time_range.start for e in recs)
        return dict(kernel_ms=(busy - copies) / reps / 1e3, copy_ms=copies / reps / 1e3,
                    span_ms=span / reps / 1e3, idle=1 - busy / span, records=len(recs) / reps)

    def fmt_breakdown(b: dict | None) -> str:
        if b is None:
            return "device breakdown not measured (no device records)"
        return (f"device records per block {b['records']:.1f}: kernels {b['kernel_ms']:.4f} ms, "
                f"copies {b['copy_ms']:.4f} ms, span {b['span_ms']:.4f} ms, idle {b['idle']:.1%}")

    def device_ms(shape, k: int, reps: int, rule=conway,
                  kernel: str = "packed_stripe_kernel") -> float | None:
        return profiled_ms(launcher(shape, k, rule), kernel, reps)

    def fmt(v: float | None) -> str:
        return "not measured (no kernel records)" if v is None else f"{v:.4f}"

    ops_per_word = ps.logic_ops_per_word_step(rule)
    int_ops_per_s = n_sm * INT_OPS_PER_CLOCK_PER_SM * sm_clock_mhz * 1e6

    def bound(shape, k: int, rule=conway) -> tuple[float, str]:
        """The larger of the words read and written once over the memory
        rate and the logic instructions over the integer issue rate (one
        more per step on each row's partial last word, for the mask)."""
        h, w = shape
        n_words = h * bitlife.packed_width(w)
        mem_ms = 2 * n_words * 4 / HBM_BYTES_PER_S * 1e3
        ops = (ps.logic_ops_per_word_step(rule) * n_words * k
               + (h * k if w % bitlife.WORD else 0))
        ops_ms = ops / int_ops_per_s * 1e3
        return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")

    def tiles(rule, k: int, rows: int, nwords: int) -> str:
        """The tiles of one K1 or K3 launch over rows x nwords words, in words."""
        t, r = ps.launch_tile_shape(rule, k, rows, nwords)
        warps = -(-(t + 2 * rule.radius * k) // r)
        return f"{t}-row tiles of {warps} warps of {r} rows ({-(-rows // t)} a strip)"

    full_nw = bitlife.packed_width(FULL)
    ms = kernel_ms((FULL, FULL), BLOCK_STEPS, 40)
    xp = words(board)
    plain_ms = cuda_ms(lambda: ps.packed_multi_step_plain(xp, rule, (FULL, FULL), BLOCK_STEPS), 3)
    bound_ms, bound_by = bound((FULL, FULL), BLOCK_STEPS)
    cells_per_s = FULL * FULL * BLOCK_STEPS / (ms * 1e-3)
    full_words = FULL * full_nw
    print(f"timing {FULL}^2 conway (rule compiled in), k={BLOCK_STEPS}, "
          f"{tiles(rule, BLOCK_STEPS, FULL, full_nw)}: "
          f"kernel {ms:.4f} ms/launch ({ms / BLOCK_STEPS:.4f} ms/step, "
          f"{cells_per_s:.4e} cells/s, {bound_ms / ms:.1%} of the bound); plain "
          f"{plain_ms / BLOCK_STEPS:.4f} ms/step; bound {bound_ms:.4f} ms/launch "
          f"({bound_by}: {ops_per_word} logic ops/word/step at "
          f"{int_ops_per_s:.4e} int ops/s; {2 * full_words * 4} bytes at "
          f"{HBM_BYTES_PER_S:.3e} B/s)", flush=True)
    sweep = {}
    for k in (1, 2, 4, 8, 16, 32):
        sweep[k] = kernel_ms((FULL, FULL), k, max(4, 64 // k)) / k
    print("ms/step by block_steps at 16384^2: " + ", ".join(
        f"k={k}: {v:.4f}" for k, v in sweep.items()), flush=True)
    full_dev_ms = device_ms((FULL, FULL), BLOCK_STEPS, 20)
    # phase 12 times these launches again after the driver's runs: (a call
    # giving the ms of one launch by CUDA events, this reading; one giving
    # its device time from the profiler's kernel records, this reading)
    retime = {f"K1 {FULL}^2 conway, k={BLOCK_STEPS}": (
        lambda: kernel_ms((FULL, FULL), BLOCK_STEPS, 40), ms,
        lambda: device_ms((FULL, FULL), BLOCK_STEPS, 20), full_dev_ms)}
    print(f"device time {FULL}^2, k={BLOCK_STEPS}: {fmt(full_dev_ms)} ms/launch "
          f"(profiler kernel records)", flush=True)
    # a rule the Moore kernels run as data, beside Conway's compiled one
    data_rule = get_rule(DATA_RULE)
    data_ms = kernel_ms((FULL, FULL), BLOCK_STEPS, 40, data_rule)
    data_dev_ms = device_ms((FULL, FULL), BLOCK_STEPS, 20, data_rule)
    data_bound = bound((FULL, FULL), BLOCK_STEPS, data_rule)[0]
    print(f"timing {FULL}^2 {DATA_RULE} (rule as data), k={BLOCK_STEPS}: kernel {data_ms:.4f} "
          f"ms/launch by CUDA events ({data_bound / data_ms:.1%} of its bound {data_bound:.4f} ms, "
          f"{ps.logic_ops_per_word_step(data_rule)} logic ops/word/step); device time "
          f"{fmt(data_dev_ms)} ms/launch against conway's {fmt(full_dev_ms)}", flush=True)
    ref = (1500, 500)
    ref_nw = bitlife.packed_width(ref[1])
    ref_ms = kernel_ms(ref, BLOCK_STEPS, 200)
    ref_dev_ms = device_ms(ref, BLOCK_STEPS, 200)
    print(f"timing 1500x500 conway, k={BLOCK_STEPS}: {ref_ms:.4f} ms/launch by CUDA "
          f"events over back-to-back calls; device time {fmt(ref_dev_ms)} ms/launch "
          f"with {tiles(rule, BLOCK_STEPS, ref[0], ref_nw)} (bound "
          f"{bound(ref, BLOCK_STEPS)[0]:.6f} ms)", flush=True)

    # -- 6. K2 at full size through the cuda backend ------------------------
    k2_rows = []
    k2_final = {}  # phase 9 holds K4's runs to these boards
    for name, side, steps in K2_FULL:
        rule = get_rule(name)
        shape = (side, side)
        board = states_board(shape, rule)
        k = kt.clamp_block_steps(rule, BLOCK_STEPS)
        runner = make_runner(backend, board, rule)
        x0 = runner.x.clone()
        kt.int8_multi_step.launches = 0
        t0 = time.perf_counter()
        drive_runner(runner, steps)
        drive_s = time.perf_counter() - t0
        launches = kt.int8_multi_step.launches
        if launches <= 0:
            fail(f"the full-size {name} run launched the int8 kernel 0 times")
        want = kt.int8_multi_step_plain(x0, rule, shape, steps)
        err = int8_err(runner.x, want)
        k2_max_err = max(k2_max_err, err)
        if err:
            fail(f"full-size {name} run != plain after {steps} steps")
        live = runner.live_count()
        if live != int((want == 1).sum()) or live <= 0:
            fail(f"full-size {name} live count {live} disagrees with the plain version")
        k2_final[name] = (board, runner.x.clone())
        print(f"full size: {name} {side}^2 x {steps} steps through the cuda backend "
              f"({launches} launches of k={k}, {drive_s:.3f} s host clock incl. first "
              f"launch) equal to plain; live cells {live}", flush=True)
        cps, _ = measure_throughput(backend, board, rule, steps, steps // 4)
        print(f"cell_updates_per_sec_per_chip {cps:.6e} ({side}^2 {name} through the "
              f"Runner, host clock, delta of {steps} and {steps // 4} steps)", flush=True)

        launch = pingpong(
            lambda a, b, rule=rule, shape=shape, k=k: kt.int8_multi_step(
                a, rule, shape, k, block_steps=k, scratch=b),
            cells(board))
        k2_ms = cuda_ms(launch, max(4, 64 // k))
        k2_dev_ms = profiled_ms(launch, "int8_tiled_kernel", max(4, 32 // k))
        retime[f"K2 {side}^2 {name}, k={k}"] = (
            lambda launch=launch, k=k: cuda_ms(launch, max(4, 64 // k)), k2_ms,
            lambda launch=launch, k=k: profiled_ms(launch, "int8_tiled_kernel", max(4, 32 // k)),
            k2_dev_ms)
        xp = cells(board)
        k2_plain_ms = cuda_ms(lambda: kt.int8_multi_step_plain(xp, rule, shape, k), 2)
        n_cells = side * side
        mem_ms = 2 * n_cells / HBM_BYTES_PER_S * 1e3
        ops_ms = kt.ops_per_cell_step(rule) * n_cells * k / int_ops_per_s * 1e3
        k2_bound, k2_by = (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")
        rows, cols = kt.tile_shape(rule, k, side, side, n_sm)
        k2_blocks = kt.blocks_per_sm("int8_tiled_kernel", kt.shared_bytes(rule, k, rows, cols))
        print(f"timing K2 {side}^2 {name}, k={k}, {rows}x{cols} tiles, "
              f"{registers['int8_tiled_kernel']} registers, {k2_blocks} blocks/SM: kernel "
              f"{k2_ms:.4f} ms/launch by CUDA events ({k2_ms / k:.4f} ms/step, "
              f"{n_cells * k / (k2_ms * 1e-3):.4e} cells/s, {k2_bound / k2_ms:.1%} of "
              f"the bound); device time {fmt(k2_dev_ms)} ms/launch (profiler kernel "
              f"records); plain {k2_plain_ms:.4f} ms per {k} steps; bound "
              f"{k2_bound:.4f} ms/launch ({k2_by}: {kt.ops_per_cell_step(rule):.5g} int "
              f"ops/cell/step at {int_ops_per_s:.4e} int ops/s = {ops_ms:.4f} ms; "
              f"{2 * n_cells} bytes at {HBM_BYTES_PER_S:.3e} B/s = {mem_ms:.4f} ms)",
              flush=True)
        k2_rows.append(dict(rule=name, shape=[side, side], steps_per_launch=k, ms=k2_ms,
                            device_ms=k2_dev_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound,
                            bound_by=k2_by, full_size_launches=launches, blocks_per_sm=k2_blocks))
        del runner, x0, want, xp, launch
        torch.cuda.empty_cache()
    k2 = k2_rows[-1]  # brians_brain at 16384^2: the deeper block, k = 8
    small = []
    for name in ("conway", "bugs"):
        rule = get_rule(name)
        k = kt.clamp_block_steps(rule, BLOCK_STEPS)
        launch = pingpong(
            lambda a, b, rule=rule, k=k: kt.int8_multi_step(a, rule, ref, k, block_steps=k, scratch=b),
            cells(states_board(ref, rule)))
        ev_ms = cuda_ms(launch, 200)
        small_dev_ms = profiled_ms(launch, "int8_tiled_kernel", 200)
        mem_ms = 2 * ref[0] * ref[1] / HBM_BYTES_PER_S * 1e3
        ops_ms = kt.ops_per_cell_step(rule) * ref[0] * ref[1] * k / int_ops_per_s * 1e3
        rows, cols = kt.tile_shape(rule, k, *ref, n_sm)
        small.append(f"{name} k={k}, {rows}x{cols} tiles: device time {fmt(small_dev_ms)} ms/launch, "
                     f"{ev_ms:.4f} by CUDA events over back-to-back calls, bound "
                     f"{max(mem_ms, ops_ms):.6f} ms ({'operations' if ops_ms >= mem_ms else 'bytes'})")
    print("timing K2 1500x500: " + "; ".join(small), flush=True)

    # -- 7. von Neumann and torus rules at full size --------------------------
    rule = get_rule(DIAMOND)
    board = rng.integers(0, 2, size=(FULL, FULL), dtype=np.int8)
    runner = make_runner(backend, board, rule)
    if runner.route != "k1_diamond":
        fail(f"rule {DIAMOND} took route {runner.route!r}, want 'k1_diamond'")
    x0 = runner.x.clone()
    ps.packed_multi_step.launches = ps.packed_multi_step.diamond_launches = 0
    t0 = time.perf_counter()
    drive_runner(runner, FULL_STEPS)
    drive_s = time.perf_counter() - t0
    diamond_full_launches = ps.packed_multi_step.diamond_launches
    if diamond_full_launches != FULL_STEPS // BLOCK_STEPS:
        fail(f"the full-size diamond run launched the diamond mode "
             f"{diamond_full_launches} times, want {FULL_STEPS // BLOCK_STEPS}")
    want = ps.packed_multi_step_plain(x0, rule, (FULL, FULL), FULL_STEPS)
    err = diff_cells(runner.x, want)
    diamond_max_err = max(diamond_max_err, err)
    if err:
        fail(f"full-size diamond run != plain after {FULL_STEPS} steps")
    live = runner.live_count()
    if live != int(bitlife.live_count_packed(want)) or live <= 0:
        fail(f"full-size diamond live count {live} disagrees with the plain version")
    print(f"full size: {DIAMOND} {FULL}^2 x {FULL_STEPS} steps through the cuda backend "
          f"(route k1_diamond, {diamond_full_launches} launches, {drive_s:.3f} s host clock) "
          f"equal to plain; live cells {live}", flush=True)
    cps, _ = measure_throughput(backend, board, rule, FULL_STEPS, FULL_STEPS // 4)
    print(f"cell_updates_per_sec_per_chip {cps:.6e} ({FULL}^2 {DIAMOND} through the "
          f"Runner, host clock, delta of {FULL_STEPS} and {FULL_STEPS // 4} steps)", flush=True)
    del runner, x0, want
    torch.cuda.empty_cache()

    diamond_rows = {}
    for name in (DIAMOND, DIAMOND_R1):
        rule = get_rule(name)
        d_ms = kernel_ms((FULL, FULL), BLOCK_STEPS, 40, rule)
        d_dev_ms = device_ms((FULL, FULL), BLOCK_STEPS, 20, rule, "packed_diamond_kernel")
        xp = words(board)
        d_plain_ms = cuda_ms(
            lambda: ps.packed_multi_step_plain(xp, rule, (FULL, FULL), BLOCK_STEPS), 2)
        d_bound, d_by = bound((FULL, FULL), BLOCK_STEPS, rule)
        d_ops = ps.logic_ops_per_word_step(rule)
        print(f"timing K1 diamond mode {FULL}^2 {name}, k={BLOCK_STEPS}, "
              f"{tiles(rule, BLOCK_STEPS, FULL, full_nw)}: kernel {d_ms:.4f} ms/launch by CUDA events "
              f"({d_ms / BLOCK_STEPS:.4f} ms/step, "
              f"{FULL * FULL * BLOCK_STEPS / (d_ms * 1e-3):.4e} cells/s, "
              f"{d_bound / d_ms:.1%} of the bound); device time {fmt(d_dev_ms)} ms/launch "
              f"(profiler kernel records); plain {d_plain_ms:.4f} ms per {BLOCK_STEPS} steps; "
              f"bound {d_bound:.4f} ms/launch ({d_by}: {d_ops} logic ops/word/step at "
              f"{int_ops_per_s:.4e} int ops/s; {2 * full_words * 4} bytes at "
              f"{HBM_BYTES_PER_S:.3e} B/s)", flush=True)
        depths = sorted({ps.clamp_block_steps(rule, k) for k in (1, 2, 4, 8, 16, 32)})
        d_sweep = {k: kernel_ms((FULL, FULL), k, max(4, 64 // k), rule) / k for k in depths}
        print(f"ms/step by block_steps at {FULL}^2, {name}: " + ", ".join(
            f"k={k}: {v:.4f}" for k, v in d_sweep.items()), flush=True)
        diamond_rows[name] = dict(ms=d_ms, device_ms=d_dev_ms, plain_ms=d_plain_ms,
                                  bound_ms=d_bound, bound_by=d_by)
        del xp
    rule = get_rule(DIAMOND)
    d_ref_ms = kernel_ms(ref, BLOCK_STEPS, 200, rule)
    d_ref_dev_ms = device_ms(ref, BLOCK_STEPS, 200, rule, "packed_diamond_kernel")
    xp = words(rng.integers(0, 2, size=ref, dtype=np.int8))
    d_ref_plain_ms = cuda_ms(lambda: ps.packed_multi_step_plain(xp, rule, ref, BLOCK_STEPS), 3)
    print(f"timing K1 diamond mode 1500x500 {DIAMOND}, k={BLOCK_STEPS}, "
          f"{tiles(rule, BLOCK_STEPS, ref[0], ref_nw)}: {d_ref_ms:.4f} ms/launch by CUDA events over back-to-back calls; device "
          f"time {fmt(d_ref_dev_ms)} ms/launch; plain {d_ref_plain_ms:.4f} ms per "
          f"{BLOCK_STEPS} steps; bound {bound(ref, BLOCK_STEPS, rule)[0]:.6f} ms", flush=True)
    del xp
    torch.cuda.empty_cache()

    # the packed torus ops: held to the int8 torus ops on the same board
    name, side, steps = TORUS_FULL
    rule = get_rule(name)
    board = rng.integers(0, 2, size=(side, side), dtype=np.int8)
    kernel_counts = lambda: (ps.packed_multi_step.launches, kt.int8_multi_step.launches)
    before = kernel_counts()
    runner = make_runner(backend, board, rule)
    other = make_runner(get_backend("cuda", bitpack=False), board, rule)
    if (runner.route, other.route) != ("packed_torus", "stencil"):
        fail(f"rule {name} took routes {runner.route!r} and (bitpack off) {other.route!r}")
    t0 = time.perf_counter()
    drive_runner(runner, steps)
    drive_s = time.perf_counter() - t0
    drive_runner(other, steps)
    if not np.array_equal(runner.fetch(), other.fetch()):
        fail(f"full-size {name}: the packed torus ops and the int8 torus ops disagree "
             f"after {steps} steps")
    live = runner.live_count()
    if live != other.live_count() or live <= 0:
        fail(f"full-size {name} live count {live} disagrees with the int8 torus ops")
    print(f"full size: {name} {side}^2 x {steps} steps through the cuda backend (route "
          f"packed_torus, no kernel, {drive_s:.3f} s host clock) equal to the int8 torus "
          f"ops; live cells {live}", flush=True)
    torus_board, torus_final = board, runner.x.clone()  # phase 9's 2-D torus is held to it
    del other
    torch.cuda.empty_cache()
    cps, _ = measure_throughput(backend, board, rule, steps, steps // 4)
    step = bitlife.make_packed_torus_step(rule, side)
    torus_ms = cuda_ms(lambda: step(runner.x), 5)
    print(f"cell_updates_per_sec_per_chip {cps:.6e} ({side}^2 {name} through the Runner, "
          f"host clock, delta of {steps} and {steps // 4} steps); packed torus ops "
          f"{torus_ms:.4f} ms/step by CUDA events", flush=True)
    del runner
    torch.cuda.empty_cache()

    # the int8 stencil ops on the torus: a torus has no edge, so the run of
    # a rolled board is the rolled run
    shift = (1234, -4321)
    for name, side, steps in STENCIL_FULL:
        rule = get_rule(name)
        board = states_board((side, side), rule)
        runner = make_runner(backend, board, rule)
        if runner.route != "stencil":
            fail(f"rule {name} took route {runner.route!r}, want 'stencil'")
        rolled = stencil.multi_step(torch.roll(runner.x, shift, dims=(0, 1)), rule=rule, steps=steps)
        t0 = time.perf_counter()
        drive_runner(runner, steps)
        drive_s = time.perf_counter() - t0
        if not torch.equal(torch.roll(runner.x, shift, dims=(0, 1)), rolled):
            fail(f"full-size {name}: the run of the rolled board is not the rolled run")
        live = runner.live_count()
        states_seen = int(runner.x.max()), int(runner.x.min())
        if live <= 0 or states_seen[0] >= rule.states or states_seen[1] < 0:
            fail(f"full-size {name}: live cells {live}, states {states_seen[1]}..{states_seen[0]}")
        del rolled
        torch.cuda.empty_cache()
        print(f"full size: {name} {side}^2 x {steps} steps through the cuda backend (route "
              f"stencil, no kernel, {drive_s:.3f} s host clock) equal under a roll by "
              f"{shift}; live cells {live}", flush=True)
        cps, _ = measure_throughput(backend, board, rule, steps, steps // 4)
        step = stencil.make_step(rule)
        stencil_ms = cuda_ms(lambda: step(runner.x), 3)
        print(f"cell_updates_per_sec_per_chip {cps:.6e} ({side}^2 {name} through the "
              f"Runner, host clock, delta of {steps} and {steps // 4} steps); int8 stencil "
              f"ops {stencil_ms:.4f} ms/step by CUDA events", flush=True)
        del runner
        torch.cuda.empty_cache()
    if kernel_counts() != before:
        fail(f"the ops routes launched a kernel: counts {before} -> {kernel_counts()}")

    # -- 8. the sharded backend at full size, 4 shards of the one card -------
    rule = conway
    n_shards = 4
    sharded = get_backend("sharded", mesh=make_mesh(devices=[dev] * n_shards))
    runner = make_runner(sharded, k1_board, rule)
    if runner.route != "k3":
        fail(f"16384^2 conway took sharded route {runner.route!r}, want 'k3'")
    k3.sharded_stripe_block.launches = halo.exchange_rows.copies = 0
    t0 = time.perf_counter()
    drive_runner(runner, FULL_STEPS)
    drive_s = time.perf_counter() - t0
    blocks = FULL_STEPS // BLOCK_STEPS
    full_counts = (k3.sharded_stripe_block.launches, halo.exchange_rows.copies)
    if full_counts != (n_shards * blocks, 2 * (n_shards - 1) * blocks):
        fail(f"the full-size sharded run made (K3 launches, halo copies) = {full_counts}, "
             f"want {(n_shards * blocks, 2 * (n_shards - 1) * blocks)}")
    err = diff_cells(runner.gather(), k1_final)
    k3_max_err = max(k3_max_err, err)
    if err:
        fail(f"the full-size sharded run != K1's board after {FULL_STEPS} steps")
    live = runner.live_count()
    if live != int(bitlife.live_count_packed(k1_final)):
        fail(f"full-size sharded live count {live} disagrees with K1's")
    print(f"full size: {FULL}^2 x {FULL_STEPS} steps through the sharded backend on "
          f"{n_shards} shards of the card (route k3, {full_counts[0]} K3 launches, "
          f"{full_counts[1]} halo copies, {drive_s:.3f} s host clock incl. first launch) "
          f"equal to K1's board; live cells {live}", flush=True)
    sh_cps, _ = measure_throughput(sharded, k1_board, rule, FULL_STEPS, FULL_STEPS // 4)
    print(f"cell_updates_per_sec_per_chip {sh_cps:.6e} ({FULL}^2 conway through the sharded "
          f"Runner on {n_shards} shards of one card, host clock, delta of {FULL_STEPS} and "
          f"{FULL_STEPS // 4} steps)", flush=True)

    # one shard's launch: the second shard, 4096 x 512 words and its halos
    hl, nw = runner.chunks[1].shape
    fr = halo.halo_depth(rule, BLOCK_STEPS)
    tops, bots = halo.exchange_rows(runner.chunks, fr, periodic=False)
    row0 = hl - fr
    shard_launch = pingpong(
        lambda a, b, top=tops[1], bot=bots[1], row0=row0, rule=rule: k3.sharded_stripe_block(
            top, a, bot, row0, rule, (FULL, FULL), BLOCK_STEPS, out=b),
        runner.chunks[1].clone())
    k3_ms = cuda_ms(shard_launch, 80)
    k3_dev_ms = profiled_ms(shard_launch, "sharded_stripe_kernel<false", 40)
    retime[f"K3 one shard of {FULL}^2 conway on {n_shards}, k={BLOCK_STEPS}"] = (
        lambda launch=shard_launch: cuda_ms(launch, 80), k3_ms,
        lambda launch=shard_launch: profiled_ms(launch, "sharded_stripe_kernel<false", 40), k3_dev_ms)
    k3_plain_ms = cuda_ms(lambda: k3.sharded_stripe_block_plain(
        tops[1], runner.chunks[1], bots[1], row0, rule, (FULL, FULL), BLOCK_STEPS), 2)
    # the bound: the rows each substep must compute (the chunk and what its
    # later substeps read of the halos) at K1's ops per word, and each input
    # word read once and each output word written once
    k3_ops = ops_per_word * nw * (BLOCK_STEPS * hl + fr * (BLOCK_STEPS - 1))
    k3_ops_ms = k3_ops / int_ops_per_s * 1e3
    k3_mem_ms = (2 * hl + 2 * fr) * nw * 4 / HBM_BYTES_PER_S * 1e3
    k3_bound, k3_by = (k3_ops_ms, "operations") if k3_ops_ms >= k3_mem_ms else (k3_mem_ms, "bytes")
    print(f"timing K3 one shard {hl}x{nw} words + 2x{fr} halo rows, conway, k={BLOCK_STEPS}, "
          f"{tiles(rule, BLOCK_STEPS, hl, nw)}: kernel {k3_ms:.4f} ms/launch by "
          f"CUDA events ({k3_bound / k3_ms:.1%} of the bound), device time {fmt(k3_dev_ms)} "
          f"ms/launch (profiler kernel records); {n_shards} shard launches {n_shards * k3_ms:.4f} "
          f"ms by events against K1's {ms:.4f} over the whole board "
          f"({n_shards * k3_ms / ms:.3f}x); by device time "
          + (f"{n_shards * k3_dev_ms:.4f} against {fmt(full_dev_ms)}"
             if k3_dev_ms is not None else "not measured")
          + f"; plain {k3_plain_ms:.4f} ms per {BLOCK_STEPS} steps; bound {k3_bound:.4f} ms "
          f"({k3_by}: {ops_per_word} logic ops/word/step over {BLOCK_STEPS * hl + fr * (BLOCK_STEPS - 1)} "
          f"word rows = {k3_ops_ms:.4f} ms; {(2 * hl + 2 * fr) * nw * 4} bytes = {k3_mem_ms:.4f} ms)",
          flush=True)
    buffers = halo.halo_buffers(runner.chunks, fr)
    exchange = lambda: halo.exchange_rows(runner.chunks, fr, periodic=False, buffers=buffers)  # noqa: E731
    xchg_ms = cuda_ms(exchange, 50)
    copy_dev_ms = profiled_ms(exchange, "Memcpy DtoD", 20)
    block_ms = cuda_ms(lambda: runner.advance(BLOCK_STEPS), 40)
    block_split = device_breakdown(lambda: runner.advance(BLOCK_STEPS), 20)
    t0 = time.perf_counter()
    for _ in range(40):
        runner.advance(BLOCK_STEPS)
    issue_ms = (time.perf_counter() - t0) / 40 * 1e3
    runner.sync()
    print(f"timing one block on {n_shards} shards: {block_ms:.4f} ms by CUDA events "
          f"({block_ms / BLOCK_STEPS:.4f} ms/step; K1 {ms / BLOCK_STEPS:.4f}); the host issues "
          f"a block in {issue_ms:.4f} ms; the exchange ({2 * (n_shards - 1)} copies of "
          f"{fr * nw * 4} bytes) {xchg_ms:.4f} ms by CUDA events, "
          + (f"{copy_dev_ms * 1e3:.2f} us of device time per copy" if copy_dev_ms is not None
             else "copy device time not measured (no memcpy records)")
          + f"; {fmt_breakdown(block_split)}; {-(-nw // ps.STRIP_WORDS)} strips of "
          f"{tiles(rule, BLOCK_STEPS, hl, nw)} per shard launch, of "
          f"{tiles(rule, BLOCK_STEPS, FULL, nw)} per K1 launch", flush=True)
    k3_row = dict(shape=[hl, FULL], ms=k3_ms, device_ms=k3_dev_ms, plain_ms=k3_plain_ms,
                  bound_ms=k3_bound, bound_by=k3_by)
    del runner, tops, bots, buffers, shard_launch
    torch.cuda.empty_cache()

    # conway:T on 4 shards through K3's torus mode, held to the packed torus ops
    name, side, steps = TORUS_FULL
    rule = get_rule(name)
    board = rng.integers(0, 2, size=(side, side), dtype=np.int8)
    runner = make_runner(sharded, board, rule)
    other = make_runner(backend, board, rule)
    if (runner.route, other.route) != ("k3_torus", "packed_torus"):
        fail(f"rule {name} took routes {runner.route!r} (sharded) and {other.route!r} (cuda)")
    k3.sharded_stripe_block.launches = 0
    drive_runner(runner, steps)
    drive_runner(other, steps)
    torus_launches = k3.sharded_stripe_block.launches
    if torus_launches != n_shards * -(-steps // BLOCK_STEPS):
        fail(f"the sharded {name} run launched K3 {torus_launches} times")
    err = diff_cells(runner.gather(), other.x)
    k3_max_err = max(k3_max_err, err)
    if err:
        fail(f"full-size {name}: k3_torus on {n_shards} shards != packed_torus after {steps} steps")
    del other
    torch.cuda.empty_cache()
    t_cps, _ = measure_throughput(sharded, board, rule, 4 * steps, steps)
    t_block_ms = cuda_ms(lambda: runner.advance(BLOCK_STEPS), 20)
    t_split = device_breakdown(lambda: runner.advance(BLOCK_STEPS), 20)
    t0 = time.perf_counter()
    for _ in range(20):
        runner.advance(BLOCK_STEPS)
    t_issue_ms = (time.perf_counter() - t0) / 20 * 1e3
    runner.sync()
    t_launch = pingpong(
        lambda a, b: k3.sharded_stripe_block(a[-fr:], a, a[:fr], 0, rule, (side, side),
                                             BLOCK_STEPS, out=b),
        runner.chunks[0].clone())
    t_dev_ms = profiled_ms(t_launch, "sharded_stripe_kernel<true", 20)
    print(f"full size: {name} {side}^2 x {steps} steps through the sharded backend on "
          f"{n_shards} shards (route k3_torus, {torus_launches} K3 launches) equal to the "
          f"packed_torus ops; {t_block_ms / BLOCK_STEPS:.4f} ms/step by CUDA events against "
          f"packed_torus's {torus_ms:.4f} (phase 7); cell_updates_per_sec_per_chip "
          f"{t_cps:.6e} (host clock, delta of {4 * steps} and {steps} steps); one shard's "
          f"torus launch {fmt(t_dev_ms)} ms of device time; one block {t_block_ms:.4f} ms by "
          f"CUDA events, issued by the host in {t_issue_ms:.4f} ms; {fmt_breakdown(t_split)}",
          flush=True)
    del runner, t_launch
    torch.cuda.empty_cache()

    # -- 9. the sharded backend at full size on 2-D meshes ------------------
    k4_rows = {}
    for name, side, steps, shape in K4_FULL:
        rule = get_rule(name)
        board, k2_board = k2_final[name]
        n_r, n_c = shape
        n_sh = n_r * n_c
        sharded = get_backend("sharded", mesh=make_mesh_2d(shape, devices=[dev] * n_sh))
        runner = make_runner(sharded, board, rule)
        if runner.route != "k4":
            fail(f"{side}^2 {name} took sharded route {runner.route!r}, want 'k4'")
        k = kt.clamp_block_steps(rule, BLOCK_STEPS)
        blocks = -(-steps // k)
        k4.sharded_int8_block.launches = halo.exchange_rows.copies = halo.exchange_cols.copies = 0
        t0 = time.perf_counter()
        drive_runner(runner, steps)
        drive_s = time.perf_counter() - t0
        counts = (k4.sharded_int8_block.launches, halo.exchange_rows.copies,
                  halo.exchange_cols.copies)
        want_counts = (n_sh * blocks, 2 * (n_r - 1) * n_c * blocks, 6 * n_r * (n_c - 1) * blocks)
        if counts != want_counts:
            fail(f"the full-size {name} run on {n_r}x{n_c} made (K4 launches, row copies, column "
                 f"copies) = {counts}, want {want_counts}")
        err = int8_err(runner.gather(), k2_board)
        k4_max_err = max(k4_max_err, err)
        if err:
            fail(f"the full-size {name} run on {n_r}x{n_c} shards != K2's board after {steps} steps")
        live = runner.live_count()
        if live != int((k2_board == 1).sum()) or live <= 0:
            fail(f"full-size {name} on {n_r}x{n_c}: live count {live} disagrees with K2's")
        print(f"full size: {name} {side}^2 x {steps} steps through the sharded backend on "
              f"{n_r}x{n_c} shards of the card (route k4, k={k}: {counts[0]} K4 launches, "
              f"{counts[1]} row and {counts[2]} column halo copies, {drive_s:.3f} s host clock "
              f"incl. first launch) equal to K2's board; live cells {live}", flush=True)
        cps, _ = measure_throughput(sharded, board, rule, steps, steps // 4)
        print(f"cell_updates_per_sec_per_chip {cps:.6e} ({side}^2 {name} through the sharded "
              f"Runner on {n_r}x{n_c} shards of one card, host clock, delta of {steps} and "
              f"{steps // 4} steps)", flush=True)

        # one shard's launch: shard 1 (the second of a row mesh, the top
        # right of a 2-D one), its halos from one exchange
        fr = halo.halo_depth(rule, k)
        fc = fr if n_c > 1 else 0
        tops, bots = halo.exchange_rows(runner.chunks, fr, periodic=False, cols=n_c)
        lefts, rights = (halo.exchange_cols(runner.chunks, tops, bots, fc, cols=n_c, periodic=False)
                         if fc else ([None] * n_sh, [None] * n_sh))
        hl, wl = runner.chunks[1].shape
        row0, col0 = 1 // n_c * hl - fr, 1 % n_c * wl - fc
        halos = dict(left=lefts[1], right=rights[1], col0=col0)
        reps = max(4, 64 // k)
        shard_launch = pingpong(
            lambda a, b, top=tops[1], bot=bots[1], row0=row0, rule=rule, side=side, k=k,
            halos=halos: k4.sharded_int8_block(top, a, bot, row0, rule, (side, side), k, out=b,
                                               **halos),
            runner.chunks[1].clone())
        k4_ms = cuda_ms(shard_launch, reps)
        k4_dev_ms = profiled_ms(shard_launch, "sharded_int8_kernel", reps)
        retime[f"K4 one shard of {side}^2 {name} on {n_r}x{n_c}, k={k}"] = (
            lambda launch=shard_launch, reps=reps: cuda_ms(launch, reps), k4_ms,
            lambda launch=shard_launch, reps=reps: profiled_ms(launch, "sharded_int8_kernel", reps),
            k4_dev_ms)
        k4_plain_ms = cuda_ms(lambda: k4.sharded_int8_block_plain(
            tops[1], runner.chunks[1], bots[1], row0, rule, (side, side), k, **halos), 2)
        # the bound: substep s computes the chunk and the halo cells later
        # substeps read, at K2's int ops per cell (bit-sliced at r = 1);
        # each input cell (the
        # chunk and its halos) read once and each output cell written once
        ops_cells = sum((hl + 2 * rule.radius * (k - s)) * (wl + (2 * rule.radius * (k - s) if fc else 0))
                        for s in range(1, k + 1))
        ops_ms = kt.ops_per_cell_step(rule) * ops_cells / int_ops_per_s * 1e3
        io_bytes = 2 * hl * wl + 2 * fr * wl + 2 * (hl + 2 * fr) * fc
        mem_ms = io_bytes / HBM_BYTES_PER_S * 1e3
        k4_bound, k4_by = (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")
        k2_row = next(r for r in k2_rows if r["rule"] == name)
        rows, cols = kt.tile_shape(rule, k, hl, wl, n_sm)
        k4_blocks = kt.blocks_per_sm("sharded_int8_kernel", kt.shared_bytes(rule, k, rows, cols))
        print(f"timing K4 one shard {hl}x{wl} + halos of {fr} rows and {fc} columns, {name}, k={k}, "
              f"{rows}x{cols} tiles, {registers['sharded_int8_kernel']} registers, {k4_blocks} "
              f"blocks/SM: kernel {k4_ms:.4f} ms/launch by CUDA events "
              f"({k4_bound / k4_ms:.1%} of the bound), device time {fmt(k4_dev_ms)} ms/launch "
              f"(profiler kernel records); {n_sh} shard launches {n_sh * k4_ms:.4f} ms by events "
              f"against K2's {k2_row['ms']:.4f} over the whole board ({n_sh * k4_ms / k2_row['ms']:.3f}x); "
              f"by device time "
              + (f"{n_sh * k4_dev_ms:.4f} against {fmt(k2_row['device_ms'])}"
                 if k4_dev_ms is not None else "not measured")
              + f"; plain {k4_plain_ms:.4f} ms per {k} steps; bound {k4_bound:.4f} ms ({k4_by}: "
              f"{kt.ops_per_cell_step(rule):.5g} int ops/cell/step over {ops_cells} cell updates = "
              f"{ops_ms:.4f} ms; {io_bytes} bytes = {mem_ms:.4f} ms)", flush=True)
        block_ms = cuda_ms(lambda: runner.advance(k), reps)
        block_split = device_breakdown(lambda: runner.advance(k), reps, "sharded_int8_kernel")
        t0 = time.perf_counter()
        for _ in range(reps):
            runner.advance(k)
        issue_ms = (time.perf_counter() - t0) / reps * 1e3
        runner.sync()
        print(f"timing one block on {n_r}x{n_c} shards, {name}: {block_ms:.4f} ms by CUDA events "
              f"({block_ms / k:.4f} ms/step; K2 {k2_row['ms'] / k:.4f}); the host issues a block "
              f"in {issue_ms:.4f} ms; {want_counts[1] // blocks} row and {want_counts[2] // blocks} "
              f"column copies a block; {fmt_breakdown(block_split)}", flush=True)
        k4_rows[(name, shape)] = dict(shape=[hl, wl], k=k, ms=k4_ms, device_ms=k4_dev_ms,
                                      plain_ms=k4_plain_ms, bound_ms=k4_bound, bound_by=k4_by,
                                      launches=counts[0], blocks_per_sm=k4_blocks)
        del runner, tops, bots, lefts, rights, halos, shard_launch, board, k2_board
        torch.cuda.empty_cache()
    # phase 13 runs bugs through the matmul counts against K2's board
    bugs_board, bugs_k2 = k2_final["bugs"][0], k2_final["bugs"][1].cpu()
    k2_final.clear()

    # conway and conway:T on 2x2 under auto: the packed plain ops, no kernel
    sharded = get_backend("sharded", mesh=make_mesh_2d((2, 2), devices=[dev] * 4))
    kernel_counts = lambda: (ps.packed_multi_step.launches, kt.int8_multi_step.launches,  # noqa: E731
                             k3.sharded_stripe_block.launches, k4.sharded_int8_block.launches)
    for name, board, steps, want, what in (
        ("conway", k1_board, FULL_STEPS, k1_final, "K1's board (phase 5)"),
        ("conway:T", torus_board, TORUS_FULL[2], torus_final, "the packed_torus board (phase 7)"),
    ):
        rule = get_rule(name)
        runner = make_runner(sharded, board, rule)
        if runner.route != "shard_ops":
            fail(f"{FULL}^2 {name} on 2x2 took route {runner.route!r}, want 'shard_ops'")
        before = kernel_counts()
        t0 = time.perf_counter()
        drive_runner(runner, steps)
        drive_s = time.perf_counter() - t0
        if kernel_counts() != before:
            fail(f"{name} on 2x2 launched a kernel: counts {before} -> {kernel_counts()}")
        err = diff_cells(runner.gather(), want)
        if err:
            fail(f"full-size {name} on 2x2 (packed plain ops) != {what} after {steps} steps")
        step_ms = cuda_ms(lambda: runner.advance(BLOCK_STEPS), 2) / BLOCK_STEPS
        print(f"full size: {name} {FULL}^2 x {steps} steps through the sharded backend on 2x2 "
              f"shards (route shard_ops, packed plain ops, no kernel, {drive_s:.3f} s host clock) "
              f"equal to {what}; {step_ms:.4f} ms/step by CUDA events", flush=True)
        del runner
        torch.cuda.empty_cache()

    # -- 10. kernel K5: the int8 Conway block kernel and its experiment ------
    conway = get_rule("conway")
    k5_max_err = 0
    k5_cases = 0
    t0 = time.perf_counter()
    for n, bh, k in K5_CASES:
        for edges in (False, True):
            board = rng.integers(0, 2, size=(n, n), dtype=np.int8)
            if edges:  # live cells on all four edges: births past them stay dead
                board[[0, -1], :] = 1
                board[:, [0, -1]] = 1
            x = cells(board)
            got = k5.conway_block(x, bh, k)
            err = int8_err(got, k5.conway_block_plain(x, k))
            torch.cuda.synchronize()
            k5_max_err = max(k5_max_err, err)
            k5_cases += 1
            if err or not torch.equal(x, cells(board)):
                fail(f"K5 != plain (or its input changed): n={n}, bh={bh}, k={k}, edges={edges}")
        del x, got
    for offset in K5_OFFSETS:
        n, bh, k = 96, 32, BLOCK_STEPS
        buf = torch.zeros(n * n + 16, dtype=torch.int8, device=dev)
        x = buf[offset:offset + n * n].view(n, n)
        x.copy_(cells(rng.integers(0, 2, size=(n, n), dtype=np.int8)))
        out = torch.zeros_like(buf)[offset:offset + n * n].view(n, n)
        got = k5.conway_block(x, bh, k, out=out)
        err = int8_err(got, k5.conway_block_plain(x, k))
        torch.cuda.synchronize()
        k5_max_err = max(k5_max_err, err)
        k5_cases += 1
        if err:
            fail(f"K5 != plain on a board at byte offset {offset}: n={n}, bh={bh}, k={k}")
    del buf, x, out, got
    for n, bh, k in K5_REFUSED:
        try:
            k5.conway_block(torch.zeros((n, n), dtype=torch.int8, device=dev), bh, k)
        except ValueError:
            continue
        fail(f"K5 took (n, bh, k) = ({n}, {bh}, {k}), outside the TPU kernel's domain")
    k5_vs_k2 = {}
    for n in K5_SIDES:
        x = cells(rng.integers(0, 2, size=(n, n), dtype=np.int8))
        got = k5.conway_block(x, 256, BLOCK_STEPS)
        want = kt.int8_multi_step(x.clone(), conway, (n, n), BLOCK_STEPS, block_steps=BLOCK_STEPS)
        err = int8_err(got, want)
        k5_max_err = max(k5_max_err, err)
        if err:
            fail(f"K5 != K2 (conway, k={BLOCK_STEPS}) at {n}^2")
        k5_vs_k2[n] = x
    print(f"kernel vs plain: K5 bit-identical to its plain version in {k5_cases} cases "
          f"(n, bh, k) = {K5_CASES}, boards random and with all four edges live, and boards at "
          f"byte offsets {K5_OFFSETS}; and to K2's "
          f"conway at k={BLOCK_STEPS} on {' and '.join(f'{n}^2' for n in K5_SIDES)}; "
          f"{len(K5_REFUSED)} shapes outside "
          f"the domain refused ({time.perf_counter() - t0:.1f} s)", flush=True)

    # the experiment's path, in process with the launch count set to 0 just
    # before and read just after, then as a subprocess, both at its defaults
    out = io.StringIO()
    k5.conway_block.launches = 0
    with contextlib.redirect_stdout(out):
        ok = block_bench.run()
    k5_main_launches = k5.conway_block.launches
    bench_lines = out.getvalue().strip().splitlines()
    if not ok or bench_lines[0] != "correct after 16 steps: True":
        fail(f"block_bench in process: {bench_lines}")
    if k5_main_launches != 12:
        fail(f"block_bench at its defaults launched K5 {k5_main_launches} times, want 2 + 10")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpu_life_torch.experiments.block_bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    bench_s = time.perf_counter() - t0
    sub_lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not sub_lines or sub_lines[0] != "correct after 16 steps: True":
        fail(f"python -m tpu_life_torch.experiments.block_bench exited {proc.returncode}: "
             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    print(f"main path K5: block_bench in process {bench_lines} ({k5_main_launches} K5 launches); "
          f"as a subprocess {sub_lines}, {bench_s:.1f} s wall clock", flush=True)

    k5_ops_per_word = ps.logic_ops_per_word_step(conway)

    def k5_bound(n: int, k: int) -> tuple[float, str, float, float]:
        """The larger of the int8 board read and written once over the
        memory rate and the fewest operations k Conway steps need, K1's
        bit-sliced logic ops a 32-cell word and step (one more per step on
        each row's partial last word, for the mask), over the integer issue
        rate.  K5 issues more (the packing, K1's instructions beyond the
        15 and its halo); the bound counts the function, not the design."""
        mem_ms = 2 * n * n / HBM_BYTES_PER_S * 1e3
        ops = k5_ops_per_word * n * bitlife.packed_width(n) * k + (n * k if n % bitlife.WORD else 0)
        ops_ms = ops / int_ops_per_s * 1e3
        return (*((ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")), ops_ms, mem_ms)

    k5_rows = {}
    for n, x in k5_vs_k2.items():
        k = BLOCK_STEPS
        launch = pingpong(lambda a, b: k5.conway_block(a, 256, k, out=b), x.clone())
        reps = 40 if n == FULL else 100
        k5_ms = cuda_ms(launch, reps)
        k5_dev_ms = profiled_ms(launch, "conway_int8_kernel", reps // 2)
        k2_launch = pingpong(lambda a, b: kt.int8_multi_step(a, conway, (n, n), k, block_steps=k,
                                                             scratch=b), x.clone())
        k2_ms = cuda_ms(k2_launch, reps // 4)
        k2_dev_ms = profiled_ms(k2_launch, "int8_tiled_kernel", reps // 4)
        k5_ms_again = cuda_ms(launch, reps)  # K5, K2, K5: the card's drift shows
        k5_plain_ms = cuda_ms(lambda: k5.conway_block_plain(x, k), 2)
        k5_bound_ms, k5_bound_by, ops_ms, mem_ms = k5_bound(n, k)
        k5_rows[n] = dict(ms=k5_ms, ms_again=k5_ms_again, device_ms=k5_dev_ms, k2_ms=k2_ms,
                          k2_device_ms=k2_dev_ms, plain_ms=k5_plain_ms, bound_ms=k5_bound_ms,
                          bound_by=k5_bound_by)
        tile_rows, warp_rows = k5.tile_shape(n, k, n_sm)
        strips = -(-bitlife.packed_width(n) // ps.STRIP_WORDS)
        print(f"timing K5 {n}^2 conway, k={k}, tiles of {tile_rows} rows, {warp_rows} rows a warp "
              f"({-(-(tile_rows + 2 * k) // warp_rows)} warps), {strips} strips of "
              f"{ps.STRIP_WORDS} words: kernel "
              f"{k5_ms:.4f} and {k5_ms_again:.4f} ms/launch by CUDA events (before and after K2; "
              f"{n * n * k / (k5_ms * 1e-3):.4e} cells/s, {k5_bound_ms / k5_ms:.1%} of the bound); "
              f"device time {fmt(k5_dev_ms)} ms/launch (profiler kernel records); K2 conway on the "
              f"same board {k2_ms:.4f} ms/launch by events, device time {fmt(k2_dev_ms)} (K5/K2 "
              f"{k5_ms / k2_ms:.3f} by events); plain {k5_plain_ms:.4f} ms per {k} steps; bound "
              f"{k5_bound_ms:.4f} ms ({k5_bound_by}: {k5_ops_per_word} logic ops/word/step at "
              f"{int_ops_per_s:.4e} int ops/s = {ops_ms:.4f} ms; {2 * n * n} bytes at "
              f"{HBM_BYTES_PER_S:.3e} B/s = {mem_ms:.4f} ms)", flush=True)
    k5_vs_k2.clear()
    del x
    torch.cuda.empty_cache()

    # -- 11. the seeded-board, gen, pattern and --bug-compat paths -----------
    t0 = time.perf_counter()
    seeded_board(SEEDED_SIDE, SEEDED_SIDE, seed=7)
    stage_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        absent = ["--config-file", str(tmp / "absent_grid.txt"),
                  "--input-file", str(tmp / "absent_data.txt")]

        def cli_run(args: list[str], out: Path, what: str) -> tuple[tuple[int, int], str]:
            """One in-process run with the K1 and K2 counts set to 0 just
            before and read just after; returns them and the route."""
            ps.packed_multi_step.launches = kt.int8_multi_step.launches = 0
            driver.run = recording_run
            try:
                rc = cli.main([*args, "--output-file", str(out)])
            finally:
                driver.run = real_run
            if rc != 0:
                fail(f"{what} exited {rc}")
            return (ps.packed_multi_step.launches, kt.int8_multi_step.launches), results[-1].route

        seeded_runs = {}
        for name, side, steps, route, want_counts in SEEDED_RUNS:
            base = ["run", *absent, "--size", str(side), "--steps", str(steps), "--seed", "7",
                    "--rule", name]
            got, took = cli_run(base, tmp / "cuda.txt", f"run --size {side} --rule {name}")
            if results[-1].seed != 7:
                fail(f"run --size {side} --rule {name}: RunResult.seed {results[-1].seed}, want 7")
            if took != route or got != want_counts:
                fail(f"run --size {side} --rule {name}: route {took!r}, (K1, K2) launches {got}; "
                     f"want {route!r}, {want_counts}")
            ref = "numpy" if side <= 512 else "torch"
            ref_counts, _ = cli_run([*base, "--backend", ref], tmp / "ref.txt",
                                    f"run --size {side} --rule {name} --backend {ref}")
            if ref_counts != (0, 0):
                fail(f"--backend {ref} launched a kernel: {ref_counts}")
            if (tmp / "cuda.txt").read_bytes() != (tmp / "ref.txt").read_bytes():
                fail(f"run --size {side} --steps {steps} --seed 7 --rule {name}: output differs "
                     f"from --backend {ref}'s bytes")
            seeded_runs[(name, side)] = (got, results[-2].elapsed_s, ref)
        print(f"seeded paths: staging one {SEEDED_SIDE}^2 board {stage_s:.3f} s (numpy Threefry "
              f"on the host); " + "; ".join(
                  f"run --size {side} --steps {steps} --seed 7 --rule {name}: (K1, K2) launches "
                  f"{seeded_runs[(name, side)][0]}, Total time {seeded_runs[(name, side)][1]:.3f} s, "
                  f"equal to --backend {seeded_runs[(name, side)][2]}'s bytes"
                  for name, side, steps, _, _ in SEEDED_RUNS), flush=True)

        # gen, then run; pattern import, then run and pattern export; each
        # equal to the numpy backend's bytes
        files = ["--config-file", str(tmp / "grid_size_data.txt"),
                 "--input-file", str(tmp / "data.txt")]
        if cli.main(["gen", "--height", "1500", "--width", "500", "--seed", "3", *files]) != 0:
            fail("gen exited non-zero")
        gen_counts, gen_route = cli_run(["run", *files], tmp / "gen_cuda.txt", "run after gen")
        cli_run(["run", *files, "--backend", "numpy"], tmp / "gen_np.txt", "run --backend numpy after gen")
        if gen_route != "k1" or gen_counts != (13, 0):
            fail(f"run after gen: route {gen_route!r}, (K1, K2) launches {gen_counts}")
        if (tmp / "gen_cuda.txt").read_bytes() != (tmp / "gen_np.txt").read_bytes():
            fail("run after gen: output differs from --backend numpy's bytes")
        if cli.main(["pattern", "import", "--name", "gosper_glider_gun", "--height", "256",
                     "--width", "256", "--steps", "300", *files]) != 0:
            fail("pattern import exited non-zero")
        pat_counts, pat_route = cli_run(["run", *files], tmp / "pat_cuda.txt", "run after pattern import")
        cli_run(["run", *files, "--backend", "numpy"], tmp / "pat_np.txt",
                "run --backend numpy after pattern import")
        if pat_route != "k1" or pat_counts != (38, 0):
            fail(f"run after pattern import: route {pat_route!r}, (K1, K2) launches {pat_counts}")
        if (tmp / "pat_cuda.txt").read_bytes() != (tmp / "pat_np.txt").read_bytes():
            fail("run after pattern import: output differs from --backend numpy's bytes")
        for src, rle in (("pat_cuda.txt", "cuda.rle"), ("pat_np.txt", "np.rle")):
            if cli.main(["pattern", "export", "--config-file", str(tmp / "grid_size_data.txt"),
                         "--input-file", str(tmp / src), "--rle", str(tmp / rle)]) != 0:
                fail("pattern export exited non-zero")
        if (tmp / "cuda.rle").read_bytes() != (tmp / "np.rle").read_bytes():
            fail("pattern export of the run's output differs from the numpy backend's")
        gun_rle_lines = len((tmp / "cuda.rle").read_text().splitlines())

        # --bug-compat on the reference workload
        with gzip.open(FIXTURES / "reference_data.txt.gz", "rb") as f:
            (tmp / "data.txt").write_bytes(f.read())
        shutil.copy(FIXTURES / "reference_grid_size_data.txt", tmp / "grid_size_data.txt")
        bug_counts, bug_route = cli_run(["run", *files, "--bug-compat"], tmp / "bug_cuda.txt",
                                        "run --bug-compat")
        cli_run(["run", *files, "--bug-compat", "--backend", "numpy"], tmp / "bug_np.txt",
                "run --bug-compat --backend numpy")
        if results[-1].rule != "B/S2" or bug_route != "k1" or bug_counts != (13, 0):
            fail(f"run --bug-compat: rule {results[-1].rule!r}, route {bug_route!r}, (K1, K2) "
                 f"launches {bug_counts}")
        if (tmp / "bug_cuda.txt").read_bytes() != (tmp / "bug_np.txt").read_bytes():
            fail("run --bug-compat: output differs from --backend numpy's bytes")
        print(f"gen --height 1500 --width 500 --seed 3, then run: route {gen_route}, (K1, K2) "
              f"launches {gen_counts}, equal to --backend numpy's bytes; pattern import --name "
              f"gosper_glider_gun (256^2, 300 steps), then run: route {pat_route}, launches "
              f"{pat_counts}, equal to numpy's bytes, and pattern export equal to numpy's "
              f"({gun_rle_lines} RLE lines); run --bug-compat on the reference workload: rule "
              f"B/S2, route {bug_route}, launches {bug_counts}, equal to numpy's bytes", flush=True)

    # -- 12. the driver's instruments and the bench entry point --------------
    def spans_ms(path: Path) -> dict[str, float]:
        """Total ms of each span and complete event of a ``--trace-events``
        file, whose B/E pairs must nest."""
        open_spans, total = [], {}
        for e in json.loads(path.read_text())["traceEvents"]:
            if e["ph"] == "B":
                open_spans.append(e)
            elif e["ph"] == "E":
                b = open_spans.pop() if open_spans else None
                if b is None or b["name"] != e["name"]:
                    fail(f"{path.name}: span {e['name']!r} closes out of order")
                total[e["name"]] = total.get(e["name"], 0.0) + (e["ts"] - b["ts"]) / 1e3
            elif e["ph"] == "X":
                total[e["name"]] = total.get(e["name"], 0.0) + e["dur"] / 1e3
        if open_spans:
            fail(f"{path.name}: spans left open: {[e['name'] for e in open_spans]}")
        return total

    def fmt_spans(t: dict[str, float]) -> str:
        return ", ".join(f"{n} {t[n]:.3f}" for n in TRACE_SPANS if n in t) + " ms"

    def kernel_counts() -> tuple[int, int, int, int]:
        return (ps.packed_multi_step.launches, kt.int8_multi_step.launches,
                k3.sharded_stripe_block.launches, k4.sharded_int8_block.launches)

    def counted(args: list[str], what: str):
        """One in-process CLI call with every launch count set to 0 just
        before and read just after: (its stdout lines, the K1-K4 counts,
        the RunResult of a run)."""
        ps.packed_multi_step.launches = ps.packed_multi_step.diamond_launches = 0
        kt.int8_multi_step.launches = k3.sharded_stripe_block.launches = 0
        k4.sharded_int8_block.launches = k5.conway_block.launches = 0
        out = io.StringIO()
        driver.run = recording_run
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main(args)
        finally:
            driver.run = real_run
        if rc != 0:
            fail(f"{what} exited {rc}")
        return out.getvalue().splitlines(), kernel_counts(), results[-1] if args[0] == "run" else None

    def golden(path: Path, what: str) -> None:
        raw = path.read_bytes()
        if len(raw) != GOLDEN_BYTES or hashlib.sha256(raw).hexdigest() != GOLDEN_SHA:
            fail(f"{what}: output.txt is not the golden {GOLDEN_BYTES} bytes, sha256 {GOLDEN_SHA}")

    conway = get_rule("conway")
    oracle_live, b = {}, ref_board
    for step in range(DRILL_EVERY, ref_steps + 1, DRILL_EVERY):
        b = run_np(b, conway, DRILL_EVERY)
        oracle_live[step] = int(np.count_nonzero(b == 1))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with gzip.open(FIXTURES / "reference_data.txt.gz", "rb") as f:
            (tmp / "data.txt").write_bytes(f.read())
        shutil.copy(FIXTURES / "reference_grid_size_data.txt", tmp / "grid_size_data.txt")
        ref_files = ["--config-file", str(tmp / "grid_size_data.txt"),
                     "--input-file", str(tmp / "data.txt")]

        # the fault drill through K1, K3 and K2: snapshots at 25 and 50, a
        # fault crossing 60, one restart from the step-50 snapshot, then 75
        # and 100 (2 kept); 4 chunks of 25 steps in all, each 3 blocks of 8
        # and one of 1
        chunk_launches = -(-DRILL_EVERY // BLOCK_STEPS)
        k2_chunk_launches = -(-DRILL_EVERY // kt.clamp_block_steps(conway, BLOCK_STEPS))
        drill_runs = {}
        for name, extra, route, want in (
            ("K1", [], "k1", (4 * chunk_launches, 0, 0, 0)),
            ("K3", ["--backend", "sharded", "--device", "cuda:0", "--num-devices", "4"], "k3",
             (0, 0, 4 * 4 * chunk_launches, 0)),
            ("K2", ["--no-bitpack"], "k2", (0, 4 * k2_chunk_launches, 0, 0)),
        ):
            d = tmp / name
            _, got, res = counted(
                ["run", *ref_files, *extra, *DRILL, "--snapshot-dir", str(d / "snaps"),
                 "--metrics-file", str(d / "m.jsonl"), "--trace-events", str(d / "t.json"),
                 "--output-file", str(d / "out.txt")], f"the {name} fault drill")
            golden(d / "out.txt", f"the {name} fault drill")
            if (res.restarts, res.route, got) != (1, route, want):
                fail(f"the {name} fault drill: restarts {res.restarts}, route {res.route!r}, "
                     f"(K1, K2, K3, K4) launches {got}; want 1, {route!r}, {want}")
            recs = [json.loads(line) for line in (d / "m.jsonl").read_text().splitlines()]
            live = [(r["step"], r["live_cells"]) for r in recs if "kind" not in r]
            if live != sorted(oracle_live.items()):
                fail(f"the {name} fault drill: (step, live) {live}, the numpy oracle's "
                     f"{sorted(oracle_live.items())}")
            if {r["run_id"] for r in recs} != {res.run_id}:
                fail(f"the {name} fault drill: metrics records of other runs than {res.run_id}")
            spans = spans_ms(d / "t.json")
            if not set(TRACE_SPANS) - {"torch-profile"} <= set(spans):
                fail(f"the {name} fault drill's trace lacks {set(TRACE_SPANS) - set(spans)}")
            kept = sorted(p.name for p in (d / "snaps").glob("*.txt"))
            if kept != ["board_000000075.txt", "board_000000100.txt"]:
                fail(f"the {name} fault drill kept snapshots {kept}")
            drill_runs[name] = (got, res.elapsed_s, spans)
        print("fault drill (" + " ".join(DRILL) + ") on the reference workload: " + "; ".join(
            f"{name}: golden sha256, 1 restart, launches (K1, K2, K3, K4) {got}, live counts "
            f"at 25/50/75/100 equal to the numpy oracle's, Total time {t:.4f} s, spans "
            f"{fmt_spans(spans)}" for name, (got, t, spans) in drill_runs.items()), flush=True)

        # --resume from the step-50 snapshot of a K1 run
        counted(["run", *ref_files, "--steps", "50", "--snapshot-every", str(DRILL_EVERY),
                 "--snapshot-dir", str(tmp / "snaps50"), "--output-file", str(tmp / "mid.txt")],
                "run --steps 50")
        _, got, res = counted(["run", *ref_files, "--resume", str(tmp / "snaps50"),
                               "--output-file", str(tmp / "resumed.txt")], "run --resume")
        golden(tmp / "resumed.txt", "run --resume from the step-50 snapshot")
        if res.steps_run != 50 or got[0] != -(-50 // BLOCK_STEPS):
            fail(f"run --resume: {res.steps_run} steps, (K1, K2, K3, K4) launches {got}")
        print(f"--resume from the step-50 snapshot: golden sha256, {res.steps_run} steps, "
              f"{got[0]} K1 launches", flush=True)

        # --profile: a torch.profiler trace of the drive that names K1, in
        # this process and in a fresh one, where it must name every launch
        # (in a process that has run for minutes the trace may drop the
        # first kernels of a window this short)
        def k1_records(trace_dir: Path, what: str) -> list[dict]:
            exported = list(trace_dir.glob("*.pt.trace.json"))
            if len(exported) != 1:
                fail(f"{what} exported {len(exported)} traces")
            return [e for e in json.loads(exported[0].read_text())["traceEvents"]
                    if e.get("cat") == "kernel" and "packed_stripe_kernel" in e.get("name", "")]

        _, got, res = counted(["run", *ref_files, "--profile", str(tmp / "prof"), "--trace-events",
                               str(tmp / "tp.json"), "--output-file", str(tmp / "prof.txt")],
                              "run --profile")
        golden(tmp / "prof.txt", "run --profile")
        in_process = k1_records(tmp / "prof", "run --profile")
        if not in_process:
            fail("the exported profile does not name packed_stripe_kernel")
        if "torch-profile" not in spans_ms(tmp / "tp.json"):
            fail("the run --profile trace has no torch-profile span")
        proc = subprocess.run([sys.executable, "-m", "tpu_life_torch", "run", *ref_files, "--profile",
                               str(tmp / "prof_sub"), "--output-file", str(tmp / "prof_sub.txt")],
                              cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"python -m tpu_life_torch run --profile exited {proc.returncode}: {proc.stderr[-2000:]}")
        golden(tmp / "prof_sub.txt", "python -m tpu_life_torch run --profile")
        fresh = k1_records(tmp / "prof_sub", "python -m tpu_life_torch run --profile")
        if len(fresh) != got[0]:
            fail(f"the profile of a fresh process names packed_stripe_kernel {len(fresh)} times for "
                 f"{got[0]} K1 launches")
        print(f"--profile: the exported trace names packed_stripe_kernel {len(in_process)} times "
              f"in process and {len(fresh)} times in a fresh process ({got[0]} launches); "
              f"{sum(e['dur'] for e in fresh) / len(fresh) / 1e3:.4f} ms of device time a launch "
              f"of 8 or 4 steps (phase 5: {fmt(ref_dev_ms)} at k={BLOCK_STEPS}); Total time "
              f"{res.elapsed_s:.4f} s in process, {proc.stdout.strip().splitlines()[-1]} in the "
              f"fresh one", flush=True)

        # the instruments' cost: the reference run bare and with them on, in turns
        instruments = ["--snapshot-every", str(DRILL_EVERY), "--keep-snapshots", "2",
                       "--metrics", "--metrics-file", str(tmp / "o.jsonl"),
                       "--trace-events", str(tmp / "o.json"), "--snapshot-dir", str(tmp / "osnaps")]
        overhead = {"bare": [], "trace": [], "instruments": []}
        for _ in range(3):
            for what, flags in (("bare", []), ("trace", ["--trace-events", str(tmp / "ot.json")]),
                                ("instruments", instruments)):
                _, got, res = counted(["run", *ref_files, *flags, "--output-file",
                                       str(tmp / "o.txt")], f"run ({what})")
                golden(tmp / "o.txt", f"run ({what})")
                overhead[what].append(res.elapsed_s)
        print(f"Total time of the reference run bare, with --trace-events, and with "
              f"--snapshot-every {DRILL_EVERY} --keep-snapshots 2 --metrics --metrics-file "
              "--trace-events (in turns): " + "; ".join(
                  f"{what} " + ", ".join(f"{t:.4f}" for t in ts) + " s"
                  for what, ts in overhead.items())
              + f"; spans of the last traced run: {fmt_spans(spans_ms(tmp / 'ot.json'))}; of the "
              f"last instrumented run: {fmt_spans(spans_ms(tmp / 'o.json'))}", flush=True)

        # the host phases at 16384^2: gen, then run with --trace-events
        big = tmp / "big"
        big_files = ["--config-file", str(big / "grid_size_data.txt"),
                     "--input-file", str(big / "data.txt")]
        big.mkdir()
        t0 = time.perf_counter()
        counted(["gen", "--height", str(FULL), "--width", str(FULL), "--steps", str(FULL_STEPS),
                 "--seed", "3", *big_files], f"gen {FULL}^2")
        gen_s = time.perf_counter() - t0
        _, got, res = counted(["run", *big_files, "--trace-events", str(big / "t.json"),
                               "--output-file", str(big / "out.txt")], f"run {FULL}^2")
        if res.route != "k1" or got != (FULL_STEPS // BLOCK_STEPS, 0, 0, 0):
            fail(f"run {FULL}^2: route {res.route!r}, (K1, K2, K3, K4) launches {got}")
        big_board = read_board(big / "data.txt", FULL, FULL)
        want = ps.packed_multi_step_plain(words(big_board), conway, (FULL, FULL), FULL_STEPS)
        if diff_cells(words(res.board), want) or (big / "out.txt").stat().st_size != FULL * (FULL + 1):
            fail(f"run {FULL}^2: output differs from the plain version's board")
        big_spans = spans_ms(big / "t.json")
        print(f"{FULL}^2 x {FULL_STEPS} steps (gen --seed 3 in {gen_s:.3f} s, then run "
              f"--trace-events): route k1, {got[0]} K1 launches, equal to the plain version; "
              f"Total time {res.elapsed_s:.3f} s; spans {fmt_spans(big_spans)}", flush=True)
        del big_board, want, res
        results.clear()

    # bench at its defaults and at 16384^2, through cuda and through 4
    # shards of the card
    for flags, kernel in (([], 0), (["--size", str(FULL)], 0),
                          (["--backend", "sharded", "--device", "cuda:0", "--num-devices", "4",
                            "--local-kernel", "cuda"], 2),
                          (["--backend", "sharded", "--device", "cuda:0", "--num-devices", "4",
                            "--local-kernel", "cuda", "--size", str(FULL)], 2)):
        lines, got, _ = counted(["bench", *flags], "bench " + " ".join(flags))
        if len(lines) != 1:
            fail(f"bench {' '.join(flags)} printed {len(lines)} lines")
        rec = json.loads(lines[0])
        print(lines[0], flush=True)
        if rec["n_chips"] != 1 or not rec["value"] > 0 or rec["platform"] != "cuda" or got[kernel] <= 0:
            fail(f"bench {' '.join(flags)}: n_chips {rec['n_chips']}, value {rec['value']}, "
                 f"platform {rec['platform']!r}, (K1, K2, K3, K4) launches {got}")

    # the kernels again, at phases 5-9's launches: the driver's instruments
    # change no kernel
    def against(again: float | None, first: float | None) -> str:
        ratio = f" ({again / first:.3f}x)" if again is not None and first is not None else ""
        return f"{fmt(again)} against {fmt(first)}{ratio}"

    print("kernels re-timed after the driver's runs, ms per launch by CUDA events and by the "
          "profiler's kernel records, against phases 5-9 in this run: " + "; ".join(
              f"{label}: events {against(events(), ev_first)}, device {against(device(), dev_first)}"
              for label, (events, ev_first, device, dev_first) in retime.items()), flush=True)

    # -- 13. banded-matmul counts and the continuous (Lenia) tier -------------
    phase13(dict(dev=dev, smi=smi, n_sm=n_sm, sm_clock_mhz=sm_clock_mhz, cuda_ms=cuda_ms,
                 counted=counted, golden=golden, bugs=(bugs_board, bugs_k2)))

    diamond = diamond_rows[DIAMOND]
    k4_row = k4_rows[("brians_brain", (2, 2))]
    print(json.dumps({"kernels": [{
        "name": "packed_stripe_multi_step",
        "route": "cuda",
        "source": "tpu_life_torch/csrc/packed_stripe.cu",
        "replaces": "tpu_life/backends/pallas_backend.py:320",
        "launches": main_launches,
        "max_abs_err": max_err,
        "equal_to_plain": max_err == 0,
        "shape": [FULL, FULL],
        "steps_per_launch": BLOCK_STEPS,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "device_ms": full_dev_ms,
        "instance": K1_MAIN,
        **k1_instances[K1_MAIN],
        "ref_device_ms": ref_dev_ms,
        "ref_instance": {"instance": K1_SMALL, **k1_instances[K1_SMALL]},
        "data_rule": {"rule": DATA_RULE, "ms": data_ms, "device_ms": data_dev_ms,
                      **k1_instances[K1_DATA]},
    }, {
        "name": "packed_diamond_multi_step",
        "route": "cuda",
        "source": "tpu_life_torch/csrc/packed_stripe.cu",
        "replaces": "tpu_life/backends/pallas_backend.py:276",
        "launches": diamond_main_launches,
        "max_abs_err": diamond_max_err,
        "equal_to_plain": diamond_max_err == 0,
        "rule": DIAMOND,
        "shape": [FULL, FULL],
        "steps_per_launch": BLOCK_STEPS,
        "ms": diamond["ms"],
        "kernel_ms": diamond["ms"],
        "plain_ms": diamond["plain_ms"],
        "bound_ms": diamond["bound_ms"],
        "bound_by": diamond["bound_by"],
        "library_ms": None,
        "device_ms": diamond["device_ms"],
        "instance": K1_DIAMOND,
        **k1_instances[K1_DIAMOND],
    }, {
        "name": "int8_tiled_multi_step",
        "route": "cuda",
        "source": "tpu_life_torch/csrc/int8_tiled.cu",
        "replaces": "tpu_life/backends/pallas_backend.py:104",
        "launches": k2_main_launches,
        "max_abs_err": k2_max_err,
        "equal_to_plain": k2_max_err == 0,
        "rule": k2["rule"],
        "shape": k2["shape"],
        "steps_per_launch": k2["steps_per_launch"],
        "ms": k2["ms"],
        "kernel_ms": k2["ms"],
        "device_ms": k2["device_ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
        "registers": registers["int8_tiled_kernel"],
        "blocks_per_sm": k2["blocks_per_sm"],
        "sass": sass_counts["int8_tiled_kernel"],
    }, {
        "name": "sharded_stripe_block",
        "route": "cuda",
        "source": "tpu_life_torch/csrc/packed_stripe.cu",
        "replaces": "tpu_life/backends/pallas_backend.py:384",
        "launches": k3_main_launches,
        "max_abs_err": k3_max_err,
        "equal_to_plain": k3_max_err == 0,
        "rule": "conway",
        "shape": k3_row["shape"],
        "steps_per_launch": BLOCK_STEPS,
        "ms": k3_row["ms"],
        "kernel_ms": k3_row["ms"],
        "device_ms": k3_row["device_ms"],
        "plain_ms": k3_row["plain_ms"],
        "bound_ms": k3_row["bound_ms"],
        "bound_by": k3_row["bound_by"],
        "library_ms": None,
        "torus_device_ms": t_dev_ms,
        "instance": K3_MAIN,
        **k1_instances[K3_MAIN],
    }, {
        "name": "sharded_int8_block",
        "route": "cuda",
        "source": "tpu_life_torch/csrc/int8_tiled.cu",
        "replaces": "tpu_life/backends/pallas_backend.py:732",
        "launches": k4_main_launches,
        "max_abs_err": k4_max_err,
        "equal_to_plain": k4_max_err == 0,
        "rule": "brians_brain",
        "mesh": [2, 2],
        "shape": k4_row["shape"],
        "steps_per_launch": k4_row["k"],
        "ms": k4_row["ms"],
        "kernel_ms": k4_row["ms"],
        "device_ms": k4_row["device_ms"],
        "plain_ms": k4_row["plain_ms"],
        "bound_ms": k4_row["bound_ms"],
        "bound_by": k4_row["bound_by"],
        "library_ms": None,
        "registers": registers["sharded_int8_kernel"],
        "blocks_per_sm": k4_row["blocks_per_sm"],
        "sass": sass_counts["sharded_int8_kernel"],
    }, {
        "name": "conway_block",
        "route": "cuda",
        "source": "tpu_life_torch/csrc/packed_stripe.cu",
        "replaces": "experiments/pallas_bench.py:93",
        "launches": k5_main_launches,
        "max_abs_err": k5_max_err,
        "equal_to_plain": k5_max_err == 0,
        "rule": "conway",
        "shape": [K5_SIDES[0], K5_SIDES[0]],
        "steps_per_launch": BLOCK_STEPS,
        "ms": k5_rows[K5_SIDES[0]]["ms"],
        "kernel_ms": k5_rows[K5_SIDES[0]]["ms"],
        "device_ms": k5_rows[K5_SIDES[0]]["device_ms"],
        "plain_ms": k5_rows[K5_SIDES[0]]["plain_ms"],
        "bound_ms": k5_rows[K5_SIDES[0]]["bound_ms"],
        "bound_by": k5_rows[K5_SIDES[0]]["bound_by"],
        "library_ms": None,
        "k2_conway_ms": k5_rows[K5_SIDES[0]]["k2_ms"],
        "full_device_ms": k5_rows[FULL]["device_ms"],
        "instance": K5_MAIN,
        **k1_instances[K5_MAIN],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def phase13(ctx: dict) -> None:
    """Phase 13: the matmul counts and Lenia through the entry points of
    ``run`` and ``bench`` on the card, no kernel of K1-K5 on their paths
    (their runs' counts must stay 0), and ``auto`` keeping K4 for a
    sharded integer rule; every time printed beside the card's name and
    power limit, and the dense-band and correlation bounds."""
    import numpy as np
    import torch

    from tpu_life_torch.backends.base import get_backend, make_runner
    from tpu_life_torch.io.codec import read_board
    from tpu_life_torch.kernels import conway_block as k5
    from tpu_life_torch.models import lenia
    from tpu_life_torch.models.rules import get_rule
    from tpu_life_torch.ops import conv, stencil

    dev, smi, cuda_ms, counted = ctx["dev"], ctx["smi"], ctx["cuda_ms"], ctx["counted"]
    # float32 outside the tensor cores: 128 lanes an SM, a fused multiply-add
    # a clock
    fp32_flops = ctx["n_sm"] * 128 * 2 * ctx["sm_clock_mhz"] * 1e6
    card = f"({smi})"
    atol = lenia.FLOAT_ATOL

    def no_kernel(got, what: str) -> None:
        if any(got) or k5.conway_block.launches:
            fail(f"{what} launched a kernel: (K1, K2, K3, K4) {got}, K5 {k5.conway_block.launches}")

    def max_err(a, b) -> float:
        a = torch.as_tensor(a, device=dev)
        return float((a - torch.as_tensor(b, device=dev)).abs().max())

    def bounds(side: int, factors: int, taps: int) -> tuple[float, float]:
        """(dense-band, correlation) least ms a step: each factor pair is two
        n x n x n products, 4 n^3 flops; the correlation itself is a
        multiply-add a tap a cell (each over the card's float32 rate; its
        bytes, the board read and written once, weigh less)."""
        dense = factors * 4.0 * side ** 3 / fp32_flops * 1e3
        corr = max(2.0 * taps * side * side / fp32_flops, 8.0 * side * side / HBM_BYTES_PER_S) * 1e3
        return dense, corr

    side, steps = LENIA_SIDE, LENIA_STEPS
    orbium = get_rule("lenia:orbium")
    n_factors = len(conv.kernel_factors(orbium.kernel))
    taps = int(np.count_nonzero(orbium.kernel))
    dense_ms, corr_ms = bounds(side, n_factors, taps)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        absent = ["--input-file", str(tmp / "absent.txt"), "--config-file", str(tmp / "absent_grid.txt")]

        # (a) Lenia on one card: run, then the same board on both stencils
        args = ["run", "--rule", "lenia:orbium", "--size", str(side), "--steps", str(steps),
                "--seed", "1", *absent, "--output-file", str(tmp / "lenia.txt")]
        _, got, res = counted(args, "run --rule lenia:orbium")
        no_kernel(got, "run --rule lenia:orbium")
        if (res.backend, res.route, res.seed) != ("torch", "lenia", 1):
            fail(f"run --rule lenia:orbium: backend {res.backend!r}, route {res.route!r}, seed {res.seed}")
        out32 = read_board(tmp / "lenia.txt", side, side)
        if out32.dtype != np.float32 or not np.isfinite(out32).all() or not 0 <= out32.min() <= out32.max() <= 1:
            fail("run --rule lenia:orbium: output.txt is not a float32 board in [0, 1]")
        t0 = time.perf_counter()
        board = lenia.seeded_board(side, side, seed=1)
        stage_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        mm = lenia.LeniaDeviceRunner(board, orbium, stencil="matmul", device=dev)
        roll = lenia.LeniaDeviceRunner(board, orbium, stencil="roll", device=dev)
        mm.advance(8)
        roll.advance(8)
        err8 = max_err(mm.x, roll.x)
        if not err8 <= atol:
            fail(f"lenia:orbium {side}^2: matmul and roll differ by {err8} after 8 steps (> {atol})")
        board8 = mm.x.clone()
        mm.advance(steps - 8)
        roll.advance(steps - 8)
        err32, err_run = max_err(mm.x, roll.x), max_err(mm.x, out32)
        # the entry point and the runner take the same path on the same
        # board: a driver fault (a step count, the staged board, the stencil,
        # a chunk) shows here; one Lenia step moves cells by up to dt
        if not err_run <= atol:
            fail(f"run --rule lenia:orbium differs from the matmul runner after {steps} steps "
                 f"by {err_run} (> {atol})")
        t_mm = cuda_ms(lambda: mm.advance(1), 4)
        t_roll = cuda_ms(lambda: roll.advance(1), 2)
        peak = torch.cuda.max_memory_allocated()
        print(f"lenia:orbium {side}^2 torus, {steps} steps through `run --seed 1` (backend torch, "
              f"route lenia, stencil auto = matmul, no kernel launch; seeded board staged in "
              f"{stage_s:.3f} s); matmul vs roll on the card: max abs error {err8:.3e} at 8 steps "
              f"(gate {atol}), {err32:.3e} at {steps} (not gated: the rule is chaotic), run vs "
              f"runner {err_run:.3e} (gate {atol}); {n_factors} factor pairs, {taps} taps; operators "
              f"{n_factors * 2 * 4 * side * side / 2**20:.1f} MiB, peak device memory "
              f"{peak / 2**30:.2f} GiB; "
              f"matmul {t_mm:.3f} ms/step ({side * side / (t_mm * 1e-3):.4e} cells/s), roll "
              f"{t_roll:.3f} ms/step ({side * side / (t_roll * 1e-3):.4e} cells/s) by CUDA events; "
              f"bounds: dense band {dense_ms:.3f} ms/step ({n_factors} x 4 x {side}^3 flops), "
              f"correlation {corr_ms:.4f} ms/step (2 x {taps} x {side}^2 flops) at "
              f"{fp32_flops:.4e} float32 flop/s {card}", flush=True)
        del mm, roll, out32
        kat = json.loads((FIXTURES / "lenia_kat.json").read_text())["cases"]
        for case in kat:
            rule = get_rule(case["rule"])
            h, w = case["height"], case["width"]
            start = np.frombuffer(base64.b64decode(case["board_b64"]), "<f4").reshape(h, w)
            want = np.frombuffer(base64.b64decode(case["expected_b64"]), "<f4").reshape(h, w)
            for st in ("roll", "matmul"):
                r = lenia.LeniaDeviceRunner(start, rule, stencil=st, device=dev)
                r.advance(case["steps"])
                if not np.allclose(r.fetch(), want, atol=atol):
                    fail(f"KAT {case['rule']}@{case['steps']} on the card through {st}: "
                         f"max abs error {max_err(r.x, want):.3e}")
        print(f"lenia KAT: {len(kat)} cases x (roll, matmul) on the card allclose to their "
              f"expected boards at atol {atol}", flush=True)

        # (b) the matmul counts: the reference workload, then phase 6's bugs board
        # through --stencil matmul against phase 6's K2 board; under auto
        # bugs keeps roll (no crossover is set on the card) and, sharded,
        # its kernel K4
        ref = tmp / "ref"
        ref.mkdir()
        with gzip.open(FIXTURES / "reference_data.txt.gz", "rb") as f:
            (ref / "data.txt").write_bytes(f.read())
        shutil.copy(FIXTURES / "reference_grid_size_data.txt", ref / "grid_size_data.txt")
        files = ["--config-file", str(ref / "grid_size_data.txt"), "--input-file", str(ref / "data.txt")]
        _, got, res = counted(["run", *files, "--backend", "torch", "--stencil", "matmul",
                               "--output-file", str(ref / "out.txt")], "run --backend torch --stencil matmul")
        no_kernel(got, "run --backend torch --stencil matmul")
        ctx["golden"](ref / "out.txt", "run --backend torch --stencil matmul")
        bugs = get_rule("bugs")
        bugs_board, bugs_k2 = ctx["bugs"]
        bugs_side = bugs_board.shape[0]
        if conv.resolve_stencil(bugs, "auto", "torch") != "roll":
            fail(f"bugs through torch under auto resolves to {conv.resolve_stencil(bugs, 'auto', 'torch')!r}")
        runner = make_runner(get_backend("torch", device=dev, stencil="matmul"), bugs_board, bugs)
        if (runner.route, runner.stencil) != ("stencil", "matmul"):
            fail(f"bugs through torch --stencil matmul: route {runner.route!r}, stencil {runner.stencil!r}")
        runner.advance(64)
        if not torch.equal(runner.x.cpu(), bugs_k2):
            fail(f"bugs {bugs_side}^2 x 64 steps through the matmul counts != phase 6's K2 board")
        bugs_mm = cuda_ms(lambda: runner.advance(1), 4)
        step = stencil.make_step(bugs)
        x = runner.x.clone()
        bugs_roll = cuda_ms(lambda: step(x), 2)
        b_dense, b_corr = bounds(bugs_side, 1, 121)
        print(f"matmul counts: `run --backend torch --stencil matmul` on the reference workload "
              f"at the golden sha256, no kernel launch; bugs {bugs_side}^2 x 64 steps through torch "
              f"--stencil matmul (auto keeps roll: crossover {conv.CROSSOVER_RADIUS}) bit-identical to "
              f"phase 6's K2 board; {bugs_mm:.3f} ms/step by CUDA events ({bugs_side ** 2 / (bugs_mm * 1e-3):.4e} "
              f"cells/s), the int8 roll stencil {bugs_roll:.3f} ms/step; bounds: dense band "
              f"{b_dense:.3f} ms/step (4 x {bugs_side}^3 flops), the box sum {b_corr:.4f} {card}", flush=True)
        del runner, x
        seeded = ["--rule", "bugs", "--size", str(side), "--steps", "16", "--seed", "3", *absent]
        _, got, res = counted(["run", *seeded, "--backend", "sharded", "--device", "cuda:0",
                               "--num-devices", "4", "--output-file", str(tmp / "bugs4.txt")],
                              "run --rule bugs --backend sharded")
        if res.route != "k4" or not got[3] or any(got[:3]):
            fail(f"run --rule bugs --backend sharded under auto: route {res.route!r}, (K1, K2, K3, K4) {got}")
        got_k4 = got[3]
        _, got, _ = counted(["run", *seeded, "--backend", "torch", "--device", "cuda:0",
                             "--output-file", str(tmp / "bugs1.txt")], "run --rule bugs --backend torch")
        no_kernel(got, "run --rule bugs --backend torch")
        if (tmp / "bugs4.txt").read_bytes() != (tmp / "bugs1.txt").read_bytes():
            fail(f"bugs {side}^2 x 16 on 4 shards through K4 != one card through torch roll")
        print(f"auto keeps the kernels: `run --rule bugs --backend sharded --num-devices 4` at "
              f"{side}^2 x 16 took route k4 ({got_k4} K4 launches) and matched torch's roll "
              f"stencil bit for bit", flush=True)

        # (c) sharded: Lenia on 4 row shards of the card, bugs:T on 2x2
        args = ["run", "--rule", "lenia:orbium", "--size", str(side), "--steps", "8", "--seed", "1",
                *absent, "--backend", "sharded", "--device", "cuda:0", "--num-devices", "4",
                "--output-file", str(tmp / "lenia_sharded.txt")]
        _, got, res = counted(args, "run --rule lenia:orbium --backend sharded --num-devices 4")
        no_kernel(got, "run --rule lenia:orbium --backend sharded")
        if res.route != "shard_ops":
            fail(f"sharded lenia took route {res.route!r}")
        err_sh = max_err(read_board(tmp / "lenia_sharded.txt", side, side), board8)
        if not err_sh <= atol:
            fail(f"sharded lenia:orbium after 8 steps differs from one card by {err_sh} (> {atol})")
        sh = make_runner(get_backend("sharded", device="cuda:0", num_devices=4, stencil="auto"),
                         board, orbium)
        k = min(8, side // 4 // orbium.radius)  # the backend's depth clamp
        sh_ms = cuda_ms(lambda: sh.advance(8), 2) / 8
        print(f"sharded: lenia:orbium {side}^2 on 4 row shards of cuda:0 (route shard_ops, closed "
              f"rings, k = {k}: halos of {k * orbium.radius} rows and columns, operators of the "
              f"{side // 4 + 2 * k * orbium.radius}x{side + 2 * k * orbium.radius} extended shard) "
              f"allclose to one card after 8 steps (max abs error "
              f"{err_sh:.3e}); {sh_ms:.3f} ms/step by CUDA events ({side * side / (sh_ms * 1e-3):.4e} "
              f"cells/s) {card}", flush=True)
        del sh, board8
        seeded = ["--rule", "bugs:T", "--size", str(side), "--steps", "32", "--seed", "3", *absent]
        _, got, res = counted(["run", *seeded, "--backend", "sharded", "--device", "cuda:0",
                               "--mesh-shape", "2,2", "--stencil", "matmul",
                               "--output-file", str(tmp / "t22.txt")], "run --rule bugs:T --mesh-shape 2,2")
        no_kernel(got, "run --rule bugs:T --mesh-shape 2,2 --stencil matmul")
        _, got, _ = counted(["run", *seeded, "--backend", "torch", "--device", "cuda:0", "--stencil",
                             "roll", "--output-file", str(tmp / "t1.txt")], "run --rule bugs:T --backend torch")
        if (tmp / "t22.txt").read_bytes() != (tmp / "t1.txt").read_bytes():
            fail(f"bugs:T {side}^2 x 32 on 2x2 through matmul != one card through roll")
        try:
            counted(["run", "--rule", "bugs:T", "--size", "64", "--steps", "2", *absent, "--backend",
                     "sharded", "--device", "cuda:0", "--num-devices", "2", "--local-kernel", "cuda",
                     "--stencil", "matmul", "--output-file", str(tmp / "x.txt")],
                    "run --local-kernel cuda --stencil matmul")
        except ValueError as e:
            refusal = str(e)
        else:
            fail("--local-kernel cuda --stencil matmul did not raise")
        print(f"sharded: bugs:T {side}^2 x 32 steps on --mesh-shape 2,2 --stencil matmul "
              f"bit-identical to one card's --stencil roll; --local-kernel cuda --stencil matmul "
              f"raises: {refusal}", flush=True)

    # (d) bench
    lines, got, _ = counted(["bench", "--rule", "lenia:orbium", "--size", str(side), "--steps", "20",
                             "--base-steps", "4", "--repeats", "2"], "bench --rule lenia:orbium")
    no_kernel(got, "bench --rule lenia:orbium")
    rec = json.loads(lines[-1])
    if (rec["backend"], rec["platform"], rec["n_chips"]) != ("torch", "cuda", 1) or not rec["value"] > 0:
        fail(f"bench --rule lenia:orbium: {lines[-1]}")
    print(lines[-1], flush=True)
    print(f"bench --rule lenia:orbium --size {side}: {rec['value']:.4e} cells/s/chip "
          f"({side * side / rec['value'] * 1e3:.3f} ms/step) {card}", flush=True)
    torch.cuda.empty_cache()


if __name__ == "__main__":
    raise SystemExit(main())
