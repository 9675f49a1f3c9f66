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
   data, clamped and on the torus, K1's Moore mode at 4, 8 and 16 rows a
   warp, and the diamonds at radius 1 and 2),
   of K5 (built with them, at 4 and 8 rows a warp) and for K2 and K4 it
   prints the registers and fails on spill stores or loads; it counts
   ``LOP3``, ``SHF``, ``SHFL``, ``LDS``, ``STS``, ``BAR`` and all
   instructions in each K1, K3 and K5 instance's SASS (and in each of K1's
   batch mode: its strips and its segments), fails if the totals of K1's
   ``<8, Conway>`` and ``<16, Conway>`` (the Moore mode's own body), K3's
   ``<false, 8, Conway>`` and K5's ``<8>`` leave 736, 1320, 736 and 4392
   (the tiles K3 and K5 share stay as they were), and the shared-memory
   loads, stores and asynchronous copies (``LDS``, ``STS``, ``LDGSTS``) in
   K2's and K4's (``cuobjdump -sass`` on the built libraries); and
   ``mc_threefry.cu`` (K6's narrow and wide instances, K7 and their batch
   modes), whose registers it prints, failing on spills, with the
   ``IADD3``, ``IMAD``, ``SHF``, ``LOP3``, ``ISETP`` and all instructions
   of each;
3. kernel vs plain — holds each kernel bit-identical (``torch.equal``) to
   its plain PyTorch version on the card (K3 and K4 below the list): K1
   over Conway (its compiled rule) and three life-like rules it runs as
   data (``highlife``, ``day_and_night``, ``seeds``), ragged shapes up to
   16384^2, widths with W % 32 of 0, 1 and 31, a board whose live cells
   touch all four edges, and depths 1, 2, 8 and 32, each with a remainder
   launch; every instance of K1's Moore mode (4, 8 and 16 rows a warp,
   Conway and ``highlife``) at tiles forced through the C entry; K1's diamond
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
   from the profiler's kernel records, with the tiles ``moore_tile_shape``
   picks;
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
   subprocess at n=4096, each printing ``correct after 16 steps: True``; K5 timed at
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
   lenia:orbium --size 4096`` (delta of 20 and 4 steps) printing its record;
14. streamed per-shard I/O and a run through ``init_distributed``, each run
   a child process of ``python -m tpu_life_torch`` that reports its launch
   counts (K1-K4), its peak RSS (``/proc/self/statm`` sampled) and its
   ``stage``/``gather``/``output-write`` spans from ``--trace-events``:
   ``gen`` of a 16384^2 board, then (a) 256 Conway steps on ``--backend
   sharded --device cuda:0 --num-devices 4 --stream-io`` (K3, 128
   launches, no ``gather`` span, a streamed ``output-write``), byte-equal
   to the same run with ``--no-stream-io`` and to ``--backend cuda`` (K1,
   32 launches, in this process); (b) ``brians_brain`` x 64 on
   ``--mesh-shape 2,2 --no-bitpack --stream-io`` (K4, 32 launches),
   byte-equal to its gathered run; (c) (a) without the flag, which streams
   (2^28 cells); (d) (a) with ``--snapshot-every 128``, then ``--resume``
   from the step-128 snapshot (64 launches), (e) that resume as the one
   process of a job (``JAX_NUM_PROCESSES=1``), which must join an NCCL
   group of one; (c) and (d) byte-equal to (a);
15. the stochastic tier (kernels K6 and K7, and K2 for a noisy base; the
   K1, K3, K4 and K5 counts stay 0) — K7 bit-identical to its plain version
   (``torch.equal``) on the Threefry known-answer vectors (both words) and
   on draws at 1500x500, 4096^2 and 16384^2 at origins 0, 2^32 - 1000 (a
   block across the 2^32 boundary) and 2^33, words 0 and 1;
   ``seeded_board(device="cuda")`` equal to the numpy copy at 4096^2 for
   states 2 and 3 and densities 0.5 and 0.3, with both staging times; K6
   bit-identical to its plain version one sweep (two launches) at a time on
   2x2, 4x30, 10x66, 258x1002, 1500x500 (random, all-up, Neel and
   half-and-half boards; T = 0, 2.27 and 10, origins 0, across 2^32 and
   past it: both instances) and 16384^2 (2 sweeps at each T, each at one
   of the origins); 16384^2 Ising at T = 2.27, seed 1, 256 sweeps through the
   ``cuda`` Runner (route ``mc_packed``, 512 K6 launches) equal to the
   ``--no-bitpack`` roll path (``mc_roll``, 512 K7 launches) bit for bit,
   each timed; ``run --rule ising --temperature 2.27 --steps 20`` on the
   reference workload, ``run --rule ising --temperature 2.27 --size 512
   --steps 64 --seed 3`` and ``run --rule noisy:0.01/conway --size 512
   --steps 64 --seed 3`` as child processes of ``python -m tpu_life_torch``
   reporting their launches (K6 40 and 128, K7 0 and 1; K2 64 and K7 65),
   each byte-equal to ``--backend numpy``'s (children too); ``--snapshot-every
   32`` then ``--resume`` from step 32, equal bytes; ``--backend sharded
   --rule ising`` exiting 2; ``bench --mc`` at its defaults (4096^2, 400 and
   40 sweeps; the numpy legs at 64 and 128) and at 16384^2 (100 and 20
   sweeps), each record printed; and K6 (4096^2, 16384^2: the instance
   launched, the draws it hashes against the active cells) and K7
   (16384^2) timed by CUDA events and the profiler's kernel records beside
   their bounds and their plain versions;
16. the serving tier (``tpu_life_torch.serve``: K1's batch mode, built with
   K1, its instances in phase 2's report and SASS counts: K1's strips on
   wide rows, the segment kernel on rows of at most 32 words) — (a) the
   batch mode bit-identical to its plain version launch by launch over
   ``chunk_plan``'s chunks, on 8 slots with budgets 0, 1, k-1, k, k+1, the
   chunk, 3 and 100: widths 1, 31, 32, 33, 255, 256, 257, 500, 511, 512,
   513, 1023, 1024 and 1025 at 97 rows (Conway, ``highlife``, the R1 and R2
   diamonds in turn, chunks of 16 and 32), Conway 8x512^2 and 8x4096^2,
   ``highlife`` 8x1500x500, the R2 diamond 8x1000x333, the small boards'
   slots equal to ``run_np``; one chunk of 16 steps (every slot stepping:
   one launch at 512^2, two of k = 8 at 4096^2) timed by CUDA events and by
   a fresh child's profiler records, beside its bound, its plain version and
   8 single-board K1 runs on the same boards; (b) the
   JAX serve bench's mix (32 sessions of 512^2 Conway x 128 steps, 8
   distinct boards, capacity 8, chunk 16, half queued at once) through
   ``python -m tpu_life_torch serve`` on ``cuda``, ``torch``, ``sharded``
   and ``numpy`` under the pipelined and the synchronous pump, every result
   equal to the numpy oracle's bytes, with sessions/s, rounds/s, batch
   occupancy, the device-idle share and K1 batch launches a chunk
   (``chunk_plan``'s, 1 on ``cuda``, counted from 0 around each run; none
   elsewhere); the governor's estimate beside
   ``torch.cuda.max_memory_allocated`` for one ``cuda`` engine; (c)
   ``submit`` + ``serve`` of the reference workload at the golden sha256,
   ``chunk_plan``'s launches a chunk (7 in all); (d) a 16384^2 Conway
   session served on ``mesh:2x2`` of the card (``--mesh-devices 4`` under a
   1 GiB budget the batch overflows), equal to the ``cuda`` backend's run; (e) a ``lenia:orbium``
   batch of 4 x 512^2 on ``cuda`` (route ``ops``), allclose at
   ``FLOAT_ATOL`` to the numpy oracle;
17. the stochastic serving tier (K6's and K7's batch modes, built with K6
   and K7 in ``mc_threefry.cu``, their instances in phase 2's report) —
   (a) both batch modes bit-identical to their plain versions at
   capacities 1, 3 and 8 with per-slot seeds, temperatures (T = 0 among
   them), start counters past 2^31 (one wrapping within a chunk) and
   budgets below, at and past the chunk (frozen slots among live ones):
   K6's over sweeps 0-3, 6-8, 14 and 15 of a chunk of 16 (each side of
   every budget's end) on 2x2 to 512^2 (rows of 1, 3, 6, 32 and 16 words:
   a thread takes 4 words of a row) at origins 0, across 2^32 and past it
   (both instances) and at 4096^2, K7's on 3x7 and 33x31 (draws not 16-byte
   aligned, tails of 5 and 7 of a thread's 8), 10x66 (a tail of 4), 1500x500
   and 1024^2 in three substreams, with the launches counted;
   (b) ``python -m tpu_life_torch sweep --size 4096 --steps 256 --temps
   1.5:3.0:8 --seed 7`` as a child process: exit 0, ``compile_counts`` a
   single 1, 512 launches of K6's batch mode and no other kernel's but the
   staging's K7, every session equal to the single-board ``cuda`` Runner
   (K6) on the same staged board, its ``elapsed_s``; K6's batch mode at 8 x
   4096^2 by CUDA events and phase 16's fresh child's profiler records beside 8
   single-board K6 launches, its plain version and its bound; K7's at 8 x
   1024^2; (c) the sweep at 1024^2 x 32 packed and ``--no-bitpack`` (64 K7
   batch launches), byte for byte; (d) 16 ``noisy:0.01/conway`` sessions
   of 512^2 x 64 (distinct seeds, capacity 8, chunk 16) through ``serve``
   under both pumps, and the reference workload as an ``ising`` session at
   T = 2.27, each equal to the single-board ``cuda`` Runner's bytes, with
   the batch modes' launches a chunk; (e) an ``ising`` session spilled
   mid-run and resumed in a fresh service, equal to the uninterrupted one;
18. the native board codec and the autotuner on the card — (a) the codec
   built with g++ from ``tpu_life_torch/csrc/codec.cpp`` decodes and encodes
   phase 14's 16384^2 board (``gen --seed 5``) byte-equal to the numpy
   codec, host ms of both, median of 3; (b) ``tune --size 16384 --rule
   conway`` measured into a temporary cache file (K1 and K3 launched, every
   ``cuda`` and ``sharded --local-kernel cuda`` candidate feasible), its
   table, the winner, the cost model's pick and the pick's measured s/step
   over the best's; (c) ``run --backend tuned`` of that board x 256 as a
   child process, natively and under ``TPU_LIFE_NATIVE=0``: resolved from
   the cache (the trace's ``autotune-pick`` event), the pick's kernel
   launched, the output byte-equal to phase 14 (a)'s, with ``stage``,
   ``gather``, ``output-write`` and ``Total time`` of both; (d) the
   reference workload served through ``--serve-backend tuned`` at the
   golden sha256 with no trial measured; (e) ``bench --backend tuned
   --size 16384`` resolving from the cache (``tuned_source: "cache"``).
19. the network front door on the card — (a) an in-process ``Gateway``
   over a ``cuda`` ``SimulationService``: the reference workload over HTTP
   at the golden sha256 (its round trip timed), 16 staggered Conway
   sessions of 512^2 x 64, each equal to the single-board ``cuda`` Runner,
   with K1's batch mode launched behind the gateway (sessions/s), and one
   ``ising`` session at T = 2.27 through K6's batch mode, equal to the
   Runner on the same seeded board; (b) as child processes, ``spill-store
   --port 0`` and ``gateway --serve-backend cuda --spill-url`` (its startup
   line naming the card's kind): ``client submit`` of the reference
   workload at the golden sha256, a Conway 1024^2 x 16384 session killed
   with SIGKILL after its first published spill, read back with
   ``read_remote_sessions`` and resumed in a fresh ``cuda`` service equal to
   the uninterrupted Runner, and a second gateway's SIGTERM exit 0 with its
   summary line; (c) ``stats --json`` on the killed gateway's sink; (d)
   ``run --backend native`` and ``--backend stripes --num-devices 4`` on the
   reference workload and ``serve --serve-backend native`` at the golden
   sha256, and ``run --backend native`` at 4096^2 x 16 (its ``Total time``,
   the host's CPUs, equal to the ``cuda`` run's bytes).
20. the fleet on the card — (a) ``python -m tpu_life_torch fleet --workers
   2 --port 0 --spill-dir … --trace-dir …`` as a child (its defaults:
   ``--serve-backend cuda``, workers on the card), its startup line and
   ``/readyz``; each worker holds the card (its pid among ``nvidia-smi
   --query-compute-apps``, or, where the card's process list shows none of
   this machine's pids, ``/dev/nvidia*`` open in the worker); through
   ``GatewayClient`` at the router 16 staggered Conway sessions of 512^2 x
   64, each equal to the single-board ``cuda`` Runner, and 2 ``ising``
   sessions of 512^2 x 64 at T = 2.27, each equal to ``MCHostRunner``
   (sessions/s); in the router's merged ``/metrics`` every worker built the
   ``cuda`` engine of the Conway key (K1's batch mode) and stepped it, and
   ``serve_packed_steps_total`` (K6's batch mode) is > 0 on every worker
   that held an ``ising`` session; (b) a Conway 1024^2 x 16384 session
   whose worker is SIGKILLed after its first spill: the supervisor respawns
   the worker (a new generation), the migrator resumes the session on the
   survivor (kill-to-resume seconds), and the result equals the
   uninterrupted Runner; (c) ``top --once --json`` on the router names both
   workers; SIGTERM drains the fleet to exit 0 with its summary line;
   ``trace merge`` on the capture, ``doctor --sid <the killed session>
   --json`` (the kill and the resume), ``doctor --slo`` and ``doctor
   --scale`` exit 0; (d) ``python -m tpu_life_torch chaos --seed 7 --workers
   2 --sessions 4 --ising-sessions 1`` (``cuda`` workers): ``ok``, every
   invariant, every session delivered, the plan digest of ``ChaosPlan(7,
   DEFAULT_POINTS)``.

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
import ctypes
import gzip
import hashlib
import io
import json
import logging
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
K1_MAIN = "K1 packed_stripe_kernel<16, ConwayRule>"
K1_DATA = "K1 packed_stripe_kernel<16, DataRule>"
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
# the integer instructions counted in K6's and K7's SASS (and the total)
MC_SASS_OPS = ("IADD3", "IMAD", "SHF", "LOP3", "ISETP")
# K6's two instances and K7 in mc_threefry.cu (label, pattern of the
# mangled name)
K6_NARROW, K6_WIDE = ("K6 packed_metropolis_half_kernel<false>",
                      "K6 packed_metropolis_half_kernel<true>")
K6_BATCH = "K6 batch packed_metropolis_batch_kernel<false>"
K7_BATCH = "K7 batch cell_uniforms_batch_kernel"
MC_INSTANCES = [(K6_NARROW, r"packed_metropolis_half_kernelILb0E"),
                (K6_WIDE, r"packed_metropolis_half_kernelILb1E"),
                ("K7 cell_uniforms_kernel", r"cell_uniforms_kernel"),
                (K6_BATCH, r"packed_metropolis_batch_kernelILb0E"),
                ("K6 batch packed_metropolis_batch_kernel<true>",
                 r"packed_metropolis_batch_kernelILb1E"),
                (K7_BATCH, r"cell_uniforms_batch_kernel")]
# phase 15: K7's boards and origins (0, a block across 2^32, past it); K6's
# shapes (W % 32 of 2 and 30, one word a row, 3 words a row so that a warp
# spans rows) and boards against its plain version, at each temperature and
# origin; the Runner's sweeps at 16384^2
MC_TEMPS = (0.0, 2.27, 10.0)
K7_SHAPES = [(1500, 500), (4096, 4096), (FULL, FULL)]
K7_ORIGINS = (0, 2**32 - 1000, 2**33)
K6_SHAPES = [(2, 2), (4, 30), (10, 66), (258, 1002), (1500, 500)]
# random (5/16 of the active cells decided), all-up (every one), Neel (none)
# and half-and-half (the columns left of w / 2 up: the domains' insides)
K6_BOARDS = ("random", "all-up", "Neel", "half-and-half")
MC_SWEEPS = 256
MC_SEEDED = 4096  # the seeded boards drawn on the card and by numpy
# the instructions counted in the SASS of every K1, K3 and K5 instance (and
# the total): logic, funnel shifts, shuffles, shared memory and barriers
K1_SASS_OPS = ("LOP3", "SHF", "SHFL", "LDS", "STS", "BAR")
# every kernel instance packed_stripe.cu builds (label, pattern of its
# mangled name): K1 Moore and K3 Moore (clamped, torus) with Conway's rule
# compiled in and with the rule as data, the diamonds at radius 1 and 2,
# K5, and K1's batch mode (Moore compiled in and as data, the diamonds),
# each at 4 and 8 rows a warp (K1's Moore mode at 16 as well)
K5_MAIN = "K5 conway_int8_kernel<8>"
STRIPE_INSTANCES = [
    *[(f"K1 packed_stripe_kernel<{n}, {r}Rule>", rf"packed_stripe_kernelILi{n}E\w*{r}Rule")
      for n in (4, 8, 16) for r in ("Conway", "Data")],
    *[(f"K1 packed_diamond_kernel<{rad}, {n}>", rf"packed_diamond_kernelILi{rad}ELi{n}E")
      for rad in (1, 2) for n in (4, 8)],
    *[(f"K3 sharded_stripe_kernel<{t}, {n}, {r}Rule>",
       rf"sharded_stripe_kernelILb{int(t == 'true')}ELi{n}E\w*{r}Rule")
      for t in ("false", "true") for n in (4, 8) for r in ("Conway", "Data")],
    *[(f"K3 sharded_diamond_kernel<{rad}, {n}>", rf"sharded_diamond_kernelILi{rad}ELi{n}E")
      for rad in (1, 2) for n in (4, 8)],
    *[(f"K5 conway_int8_kernel<{n}>", rf"conway_int8_kernelILi{n}E") for n in (4, 8)],
    *[(f"K1 batch packed_batch_kernel<{rad}, {n}, {r}Rule>",
       rf"packed_batch_kernelILi{rad}ELi{n}E\w*{r}Rule")
      for rad, r in ((0, "Conway"), (0, "Data"), (1, "Data"), (2, "Data")) for n in (4, 8)],
    *[(f"K1 batch packed_batch_segment_kernel<{rad}, {n}, {r}Rule>",
       rf"packed_batch_segment_kernelILi{rad}ELi{n}E\w*{r}Rule")
      for rad, r in ((0, "Conway"), (0, "Data"), (1, "Data"), (2, "Data")) for n in (4, 8)],
]
K1_BATCH = "K1 batch packed_batch_kernel<0, 8, ConwayRule>"
# the instance the serve mix's chunks run (8 x 512^2, k = 16: segments of 16
# lanes, 4 rows a segment)
K1_SEGMENT = "K1 batch packed_batch_segment_kernel<0, 4, ConwayRule>"
# the SASS totals of the main instances of K1, K3 and K5: K3 and K5 share
# the tiles K1's batch mode runs, K1's Moore mode has a body of its own (the
# instance of 16 rows a warp runs 16384^2 at k = 8; PERF.md)
SHARED_TILE_SASS = {"K1 packed_stripe_kernel<8, ConwayRule>": 736,
                    "K1 packed_stripe_kernel<16, ConwayRule>": 1320,
                    "K3 sharded_stripe_kernel<false, 8, ConwayRule>": 736,
                    "K5 conway_int8_kernel<8>": 4392}
# phase 16: K1's batch mode timed on 8 boards of these sides; the serve mix
# (the JAX serve bench's: sessions of P16_SIDE^2 conway x P16_STEPS,
# capacity 8, chunk P16_CHUNK), run P16_REPEATS times on each card backend
# and pump; the K2 keys' sessions (brians_brain x P16_K2_STEPS); the
# mega-board's steps
P16_SIDES = (512, 4096)
# phase 16 (a): every segment width of K1's batch mode and both sides of
# each boundary, the rules taken in turn
P16_WIDTHS = (1, 31, 32, 33, 255, 256, 257, 500, 511, 512, 513, 1023, 1024, 1025)
P16_RULES = ("conway", "highlife", "R1,C0,S1..2,B1,NN", "R2,C2,S2..4,B2..3,NN")
P16_SIDE, P16_STEPS, P16_SESSIONS, P16_CHUNK = 512, 128, 32, 16
P16_REPEATS = 7
P16_K2_STEPS = 32
P16_MEGA_STEPS = 64
# phase 17: K6's and K7's batch modes against their plain versions (the
# capacities; K6's shapes, the wide instance's origins on the small ones;
# K7's shapes); the sweep at full width and its roll twin; the noisy spool
# (sessions of side^2 x steps, distinct seeds); the spilled session
P17_CAPACITIES = (1, 3, 8)
# K6's sweeps of a chunk checked on the small boards: each side of every
# budget's last live sweep (budgets 1, 3, 7, 15, 16, 17 and past the chunk)
P17_OFFSETS = (0, 1, 2, 3, 6, 7, 8, 14, 15)
# K6's shapes: rows of 1, 3, 6 (a group of 4 words and one of 2), 16 and 32
# words (the batch mode takes 4 words of a row a thread)
P17_K6_SHAPES = [(2, 2), (10, 66), (14, 190), (258, 1002), (512, 512), (4096, 4096)]
P17_K6_ORIGINS = (0, 2**32 - 1000, 2**33 + 5)
# K7's: 8 draws a thread, so tails of 5, 4 (660 cells) and 7 draws, and
# slots whose draws are not 16-byte aligned (21 and 1023 cells)
P17_K7_SHAPES = [(3, 7), (33, 31), (10, 66), (1500, 500), (1024, 1024)]
P17_TEMPS, P17_SEED, P17_CHUNK = "1.5:3.0:8", 7, 16
P17_SIDE, P17_STEPS = 4096, 256
P17_ROLL_SIDE, P17_ROLL_STEPS = 1024, 32
P17_NOISY, P17_NOISY_SIDE, P17_NOISY_STEPS, P17_NOISY_SESSIONS = "noisy:0.01/conway", 512, 64, 16
P17_SPILL_SIDE, P17_SPILL_STEPS = 1024, 128
# phase 19: the staggered Conway sessions behind the in-process gateway; the
# ising session; the Conway session killed with SIGKILL mid-run (its steps
# outlast the kill by seconds); the host backends' timed run
P19_SIDE, P19_STEPS, P19_SESSIONS = 512, 64, 16
P19_ISING_SIDE, P19_ISING_STEPS, P19_ISING_SEED = 512, 64, 23
P19_KILL_SIDE, P19_KILL_STEPS, P19_KILL_SEED = 1024, 16384, 29
P19_NATIVE_SIDE, P19_NATIVE_STEPS = 4096, 16
# phase 20: the fleet's staggered Conway and ising sessions (as phase 19's);
# the session whose worker is SIGKILLed
P20_SIDE, P20_STEPS, P20_SESSIONS, P20_ISING = 512, 64, 16, 2
P20_KILL_SIDE, P20_KILL_STEPS, P20_KILL_SEED = 1024, 32768, 31
# phase 21: the K1 batch-mode key and the route-ops key served side by side
# (chunk P21_CHUNK, capacity 8); the free bytes left on the card while the
# ops key is squeezed (less than one plain step of its batch needs, more
# than the K1 key's per-chunk budgets tensor)
P21_SIDE, P21_STEPS, P21_SESSIONS = 512, 128, 8
P21_OPS_SIDE, P21_OPS_STEPS, P21_OPS_SESSIONS = 4096, 32, 4
P21_CHUNK, P21_MARGIN = 8, 64 << 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


class DemotionWatch(logging.Handler):
    """Records every in-place recovery the port's schedulers in this
    process log with outcome ``oom_host_demoted``: a key moved to its host
    twin would stand in for a kernel in phases 16-20."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.seen: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        if "oom_host_demoted" in msg:
            self.seen.append(msg)


def no_demotion(where: str, watch: DemotionWatch, *texts: str) -> None:
    """Fail if a key was demoted to the host: in this process (``watch``)
    or in a child's logs, metrics or stats (``texts``)."""
    if watch.seen or any("oom_host_demoted" in t for t in texts):
        fail(f"{where}: a key was demoted to its host twin: {watch.seen or 'in a child'}")


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


def sass_counts_of(lib: Path, count=K1_SASS_OPS) -> dict[str, dict[str, int]]:
    """The counts of the instructions ``count`` and of all instructions in
    each kernel's SASS (``cuobjdump -sass``), by mangled name."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts = {}
    for m in re.finditer(r"Function : (\w+)\n(.*?)(?=\n\s+Function : |\Z)", sass, re.S):
        ops = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", m.group(2), re.M)
        counts[m.group(1)] = {**{op: sum(o == op for o in ops) for op in count},
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
        from tpu_life_torch.kernels import mc_threefry as mct
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
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, together
        libs = list(pool.map(lambda m: m.build(), (ps, kt, mct)))
    ps._library()
    kt._library()
    mct._library()
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
    for label, total in SHARED_TILE_SASS.items():
        if k1_instances[label]["sass"]["total"] != total:
            fail(f"{label}: {k1_instances[label]['sass']['total']} SASS instructions, want {total}")
    print("K1, K3 and K5's main instances keep their SASS totals: " + ", ".join(
        f"{label} {total}" for label, total in SHARED_TILE_SASS.items()), flush=True)
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
    # K6's instances and K7 (mc_threefry.cu): registers, no spill, their integer SASS
    mc_report, mc_sass = ptxas_report(libs[2]), sass_counts_of(libs[2], MC_SASS_OPS)
    mc_instances = {}
    for label, pattern in MC_INSTANCES:
        names = [n for n in mc_report if re.search(pattern, n)]
        if len(names) != 1 or names[0] not in mc_sass:
            fail(f"the ptxas report or the SASS of mc_threefry.cu names {len(names)} kernels for {label}")
        spill_st, spill_ld, regs = mc_report[names[0]]
        if spill_st or spill_ld:
            fail(f"{label} spills: {spill_st} bytes of stores, {spill_ld} bytes of loads")
        mc_instances[label] = dict(registers=regs, sass=mc_sass[names[0]])
    print("K6's two instances, K7 and their batch modes (ptxas, cuobjdump -sass): " + "; ".join(
        f"{label} {inst['registers']} registers, no spill, SASS "
        + ", ".join(f"{op} {n}" for op, n in inst["sass"].items())
        for label, inst in mc_instances.items()), flush=True)
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

    # every instance of K1's Moore mode (4, 8 and 16 rows a warp, Conway
    # compiled in and as data) at tiles forced through the C entry, whatever
    # the wrapper's pick takes: the most warps the instance allows and half
    # of them, at depths 1, 8 and 32
    stripe_fn = ps._library().packed_stripe_multi_step
    forced = 0
    t0 = time.perf_counter()
    for h, w in ((300, 993), (257, 1000), (2000, 2048)):
        x0 = words(rng.integers(0, 2, size=(h, w), dtype=np.int8))
        nw = x0.shape[1]
        for name in ("conway", "highlife"):
            rule = get_rule(name)
            for warp_rows in ps.MOORE_WARP_ROWS:
                top = ps.moore_max_warps(warp_rows)
                for warps in (top, top // 2):
                    for k in (1, 8, 32):
                        rows = min(warps * warp_rows - 2 * k, h)
                        if rows < 1:
                            continue
                        got = torch.empty_like(x0)
                        err = stripe_fn(x0.data_ptr(), got.data_ptr(), h, nw, w % bitlife.WORD, k,
                                        rows, warp_rows, int(ps.compiled_rule(rule)),
                                        ctypes.byref(ps.cached_sop_table(rule)),
                                        torch.cuda.current_stream().cuda_stream)
                        if err:
                            fail(f"packed_stripe_multi_step refused {rows}-row tiles of "
                                 f"{warp_rows} rows a warp at k={k}: CUDA error {err}")
                        if diff_cells(got, ps.packed_multi_step_plain(x0, rule, (h, w), k)):
                            fail(f"K1 instance of {warp_rows} rows a warp != plain: rule {name}, "
                                 f"{h}x{w}, {rows}-row tiles, k={k}")
                        forced += 1
    print(f"K1's Moore instances at forced tiles vs plain: {forced} cases bit-identical, rows a warp "
          f"{', '.join(map(str, ps.MOORE_WARP_ROWS))}, conway and highlife "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

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

    def tiles(rule, k: int, rows: int, nwords: int, moore: bool = False) -> str:
        """The tiles of one K1 or K3 launch over rows x nwords words, in words
        (moore: K1's Moore mode, its own tiles)."""
        if moore:
            t, r = ps.moore_tile_shape(k, rows, nwords, n_sm)
        else:
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
          f"{tiles(rule, BLOCK_STEPS, FULL, full_nw, moore=True)}: "
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
          f"with {tiles(rule, BLOCK_STEPS, ref[0], ref_nw, moore=True)} (bound "
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
          f"{tiles(rule, BLOCK_STEPS, FULL, nw, moore=True)} per K1 launch", flush=True)
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

    # the experiment's path, in process at its defaults with the launch
    # count set to 0 just before and read just after, then as a subprocess
    # at n = 4096 (its numpy check of 2k steps costs a quarter of the
    # default's)
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
    proc = subprocess.run([sys.executable, "-m", "tpu_life_torch.experiments.block_bench",
                           "n=4096"], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    bench_s = time.perf_counter() - t0
    sub_lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not sub_lines or sub_lines[0] != "correct after 16 steps: True":
        fail(f"python -m tpu_life_torch.experiments.block_bench exited {proc.returncode}: "
             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    print(f"main path K5: block_bench in process {bench_lines} ({k5_main_launches} K5 launches); "
          f"as a subprocess (n=4096) {sub_lines}, {bench_s:.1f} s wall clock", flush=True)

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

    # -- 14. streamed per-shard I/O and a run through init_distributed --------
    streamed = phase14(dict(smi=smi, counted=counted, spans_ms=spans_ms, fmt_spans=fmt_spans))

    # -- 15. the stochastic tier: K6 and K7 ------------------------------------
    mc_rows = phase15(dict(dev=dev, smi=smi, n_sm=n_sm, sm_clock_mhz=sm_clock_mhz,
                           cuda_ms=cuda_ms, counted=counted,
                           golden=golden, instances=mc_instances))

    # phases 16-20 serve on the card: no key may move to its host twin there
    watch = DemotionWatch()
    logging.getLogger("tpu_life_torch").addHandler(watch)

    # -- 16. the serving tier: K1's batch mode, submit and serve --------------
    batch_row = phase16(dict(dev=dev, smi=smi, n_sm=n_sm, sm_clock_mhz=sm_clock_mhz,
                             instances=k1_instances))
    no_demotion("phase 16", watch)

    # -- 17. the stochastic serving tier: K6's and K7's batch modes ----------
    mc_batch_rows = phase17(dict(dev=dev, smi=smi, n_sm=n_sm, sm_clock_mhz=sm_clock_mhz,
                                 instances=mc_instances,
                                 device=batch_row.pop("mc_batch_device"), watch=watch))
    no_demotion("phase 17", watch)

    # -- 18. the native codec and the autotuner on the card ------------------
    tuned = phase18(dict(smi=smi, counted=counted, spans_ms=spans_ms, a_sha=streamed["sha"],
                         golden=golden))
    no_demotion("phase 18", watch)

    # -- 19. the network front door: gateway, client, spill store, stats ----
    front = phase19(dict(smi=smi, counted=counted, golden=golden, watch=watch))
    no_demotion("phase 19", watch)

    # -- 20. the fleet: router, supervisor and migrator over cuda workers ----
    fleet = phase20(dict(smi=smi, watch=watch))
    no_demotion("phase 20", watch)
    logging.getLogger("tpu_life_torch").removeHandler(watch)

    # -- 21. serving recovery: a real OOM mid-launch, the ladder to the host -
    ladder = phase21(dict(smi=smi))

    batch_row.update(tuned_serve_launches=tuned["served_batch"],
                     tuned_serve_pick=tuned["served_pick"],
                     gateway_launches=front["k1_batch"],
                     fleet_workers_built=fleet["k1_batch_workers"],
                     oom_phase_launches=ladder["k1_batch"])
    mc_batch_rows[0]["gateway_launches"] = front["k6_batch"]
    mc_batch_rows[0]["fleet_packed_steps"] = fleet["k6_packed_steps"]
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
        "tune_launches": tuned["k1"],
        "tuned_run_launches": tuned["run_k1"],
        "tuned_pick": tuned["pick"],
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
        "serve_launches": batch_row.pop("k2_serve_launches"),
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
        "streamed_launches": streamed["k3"],
        "tune_launches": tuned["k3"],
        "tuned_run_launches": tuned["run_k3"],
        "tuned_pick": tuned["pick"],
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
        "streamed_launches": streamed["k4"],
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
    }, *mc_rows, batch_row, *mc_batch_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


# phase 14's children: ``python -m tpu_life_torch`` run as ``__main__`` (as
# ``-m`` runs it), which then prints its launch counts (K1-K4), whether it
# joined a process group and over which transport, and its peak host RSS:
# the most of ``/proc/self/statm``'s resident pages, sampled every 2 ms by a
# thread, beside its ``ru_maxrss`` (which after exec keeps the forking
# parent's peak, so it reads the parent's size; some kernels give no
# ``VmHWM``)
P14_CHILD = """
import json, os, resource, runpy, sys, threading, time
import torch.distributed as dist
from tpu_life_torch.kernels import int8_tiled, packed_stripe, sharded_int8, sharded_stripe
page, peak = os.sysconf("SC_PAGE_SIZE"), [None]
def sample():
    try:
        while True:
            with open("/proc/self/statm") as f:
                peak[0] = max(peak[0] or 0, int(f.read().split()[1]) * page)
            time.sleep(0.002)
    except OSError:  # no statm: the peak stays unmeasured
        peak[0] = None
threading.Thread(target=sample, daemon=True).start()
sys.argv = ["tpu_life_torch", *sys.argv[1:]]
rc = 0
try:
    runpy.run_module("tpu_life_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    rc = e.code or 0
print("P14 " + json.dumps({
    "launches": [packed_stripe.packed_multi_step.launches, int8_tiled.int8_multi_step.launches,
                 sharded_stripe.sharded_stripe_block.launches,
                 sharded_int8.sharded_int8_block.launches],
    "process_group": dist.get_backend() if dist.is_initialized() else None,
    "world": dist.get_world_size() if dist.is_initialized() else None,
    "statm_peak_bytes": peak[0],
    "ru_maxrss_kib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}), flush=True)
sys.exit(rc)
"""


def phase14(ctx: dict) -> dict:
    """Phase 14: streamed per-shard I/O (``--stream-io``) and one run through
    ``init_distributed`` at 16384^2, each run a child process of ``python -m
    tpu_life_torch``, held byte for byte to the gathered runs and to K1;
    returns the K3 and K4 launches of the streamed runs."""
    import socket

    counted, spans_ms, fmt_spans, smi = (ctx["counted"], ctx["spans_ms"], ctx["fmt_spans"],
                                         ctx["smi"])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    shards = ["--backend", "sharded", "--device", "cuda:0", "--num-devices", "4"]
    k3_run = 4 * FULL_STEPS // BLOCK_STEPS  # 4 shards, 32 blocks
    t_phase = time.perf_counter()

    def child(tmp: Path, name: str, args: list[str], want: tuple[int, int, int, int],
              extra_env: dict | None = None) -> dict:
        """One child run into ``tmp/name.txt`` with a trace: its sha256,
        launches, spans, Total time, wall seconds and peak RSS."""
        out, trace = tmp / f"{name}.txt", tmp / f"{name}.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", P14_CHILD, "run", *args, "--trace-events", str(trace),
             "--output-file", str(out)],
            cwd=tmp, env=dict(env, **(extra_env or {})), capture_output=True, text=True,
            timeout=600)
        wall = time.perf_counter() - t0
        stdout = proc.stdout
        if proc.returncode != 0:
            fail(f"phase 14 {name}: exited {proc.returncode}: {proc.stderr[-3000:]}")
        rec = json.loads([ln for ln in stdout.splitlines() if ln.startswith("P14 ")][-1][4:])
        total = [ln for ln in stdout.splitlines() if ln.startswith("Total time = ")]
        if len(total) != 1:
            fail(f"phase 14 {name}: {len(total)} 'Total time' lines")
        if tuple(rec["launches"]) != want:
            fail(f"phase 14 {name}: (K1, K2, K3, K4) launches {rec['launches']}, want {want}")
        raw = out.read_bytes()
        if len(raw) != FULL * (FULL + 1):
            fail(f"phase 14 {name}: output.txt of {len(raw)} bytes")
        spans = spans_ms(trace)
        events = json.loads(trace.read_text())["traceEvents"]
        streamed_writes = [e["args"].get("streamed") for e in events
                           if e.get("ph") == "B" and e["name"] == "output-write"]
        out.unlink()
        return dict(sha=hashlib.sha256(raw).hexdigest(), launches=rec["launches"], spans=spans,
                    streamed=streamed_writes, total=total[0].split("=")[1].strip(), wall=wall,
                    rss_mib=(None if rec["statm_peak_bytes"] is None
                             else rec["statm_peak_bytes"] / 2**20),
                    ru_mib=rec["ru_maxrss_kib"] / 1024,
                    pg=(rec["process_group"], rec["world"]))

    def mib(v: float | None) -> str:
        return "not measured (no /proc/self/statm)" if v is None else f"{v:.1f} MiB"

    def show(name: str, r: dict) -> str:
        return (f"{name}: sha256 {r['sha'][:12]}, launches (K1, K2, K3, K4) {tuple(r['launches'])}, "
                f"Total time {r['total']} s, wall {r['wall']:.2f} s, peak RSS {mib(r['rss_mib'])} "
                f"(ru_maxrss {r['ru_mib']:.1f} MiB, the forking parent's included), "
                f"spans {fmt_spans(r['spans'])}")

    def streamed_ok(name: str, r: dict, streamed: bool) -> None:
        if r["streamed"] != [streamed] or ("gather" in r["spans"]) == streamed:
            fail(f"phase 14 {name}: output-write streamed {r['streamed']}, gather span "
                 f"{'gather' in r['spans']}; want streamed={streamed}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        files = ["--config-file", str(tmp / "grid_size_data.txt"), "--input-file",
                 str(tmp / "data.txt")]
        counted(["gen", "--height", str(FULL), "--width", str(FULL), "--steps", str(FULL_STEPS),
                 "--seed", "5", *files], f"gen {FULL}^2")
        runs = {}
        # (a) streamed on 4 row shards (K3) and gathered, each a child, and
        # one card (K1) in this process as the yardstick
        runs["a stream"] = child(tmp, "a", [*files, *shards, "--stream-io"], (0, 0, k3_run, 0))
        runs["a gathered"] = child(tmp, "a2", [*files, *shards, "--no-stream-io"], (0, 0, k3_run, 0))
        _, k1_counts, _ = counted(["run", *files, "--device", "cuda:0", "--output-file",
                                   str(tmp / "k1.txt")], f"run {FULL}^2 through K1")
        k1_sha = hashlib.sha256((tmp / "k1.txt").read_bytes()).hexdigest()
        (tmp / "k1.txt").unlink()
        if k1_counts != (FULL_STEPS // BLOCK_STEPS, 0, 0, 0):
            fail(f"phase 14 (a): the K1 run's (K1, K2, K3, K4) launches {k1_counts}")
        streamed_ok("(a) --stream-io", runs["a stream"], True)
        streamed_ok("(a) --no-stream-io", runs["a gathered"], False)
        if {runs["a stream"]["sha"], runs["a gathered"]["sha"]} != {k1_sha}:
            fail("phase 14 (a): streamed, gathered and K1 outputs differ")
        # (b) brians_brain on 2x2, unpacked (K4), streamed and gathered
        b_args = [*files, "--rule", "brians_brain", "--steps", "64", "--backend", "sharded",
                  "--device", "cuda:0", "--mesh-shape", "2,2", "--no-bitpack"]
        k4_run = 4 * 64 // BLOCK_STEPS
        runs["b stream"] = child(tmp, "b", [*b_args, "--stream-io"], (0, 0, 0, k4_run))
        runs["b gathered"] = child(tmp, "b2", [*b_args, "--no-stream-io"], (0, 0, 0, k4_run))
        streamed_ok("(b) --stream-io", runs["b stream"], True)
        if runs["b stream"]["sha"] != runs["b gathered"]["sha"]:
            fail("phase 14 (b): streamed and gathered 2x2 K4 outputs differ")
        # (c) no flag: 16384^2 is 2^28 cells, so the driver streams
        runs["c auto"] = child(tmp, "c", [*files, *shards], (0, 0, k3_run, 0))
        streamed_ok("(c) auto", runs["c auto"], True)
        # (d) streamed snapshots, then --resume from step 128
        half = FULL_STEPS // 2
        runs["d snapshots"] = child(tmp, "d", [*files, *shards, "--stream-io", "--snapshot-every",
                                               str(half), "--snapshot-dir", str(tmp / "snaps")],
                                    (0, 0, k3_run, 0))
        snaps = sorted(p.name for p in (tmp / "snaps").glob("*.txt"))
        if snaps != [f"board_{half:09d}.txt", f"board_{FULL_STEPS:09d}.txt"]:
            fail(f"phase 14 (d): snapshots {snaps}")
        # (e) the resume runs as the one process of a job through
        # init_distributed (NCCL, world 1)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        runs["d+e resume, init_distributed"] = child(
            tmp, "d2", [*files, *shards, "--stream-io", "--resume",
                        str(tmp / "snaps" / f"board_{half:09d}.txt")], (0, 0, k3_run // 2, 0),
            extra_env={"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_NUM_PROCESSES": "1",
                       "JAX_PROCESS_ID": "0"})
        shutil.rmtree(tmp / "snaps")
        if runs["d+e resume, init_distributed"]["pg"] != ("nccl", 1):
            fail(f"phase 14 (e): process group {runs['d+e resume, init_distributed']['pg']}, "
                 f"want nccl of 1")
        for name in ("c auto", "d snapshots", "d+e resume, init_distributed"):
            if runs[name]["sha"] != runs["a stream"]["sha"]:
                fail(f"phase 14 {name}: output differs from (a)'s")
    print(f"phase 14, {FULL}^2 (card: {smi}; one child process a run, board gen --seed 5): "
          f"every output byte-equal within its group (a, c, d, e: conway x {FULL_STEPS} streamed "
          f"on 4 row shards, gathered, auto-streamed, resumed from the step-{half} snapshot "
          f"through init_distributed, and K1 in this process ({k1_counts[0]} launches, sha256 "
          f"{k1_sha[:12]}); b: brians_brain x 64 on 2x2 streamed and gathered)", flush=True)
    for name, r in runs.items():
        print(f"  {show(name, r)}", flush=True)
    print(f"  peak RSS streamed vs gathered: (a) {mib(runs['a stream']['rss_mib'])} vs "
          f"{mib(runs['a gathered']['rss_mib'])}, (b) {mib(runs['b stream']['rss_mib'])} vs "
          f"{mib(runs['b gathered']['rss_mib'])}; (e) joined a "
          f"{runs['d+e resume, init_distributed']['pg'][0]} group of "
          f"{runs['d+e resume, init_distributed']['pg'][1]}; phase 14 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"k3": runs["a stream"]["launches"][2], "k4": runs["b stream"]["launches"][3],
            "sha": runs["a stream"]["sha"]}


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



# phase 15's children: ``python -m tpu_life_torch`` run as ``__main__``,
# which then prints the launch counts of K1-K7
P15_CHILD = """
import json, runpy, sys
from tpu_life_torch.kernels import (conway_block, int8_tiled, mc_threefry, packed_stripe,
                                    sharded_int8, sharded_stripe)
sys.argv = ["tpu_life_torch", *sys.argv[1:]]
rc = 0
try:
    runpy.run_module("tpu_life_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    rc = e.code or 0
print("P15 " + json.dumps([
    packed_stripe.packed_multi_step.launches + packed_stripe.packed_multi_step.diamond_launches,
    int8_tiled.int8_multi_step.launches, sharded_stripe.sharded_stripe_block.launches,
    sharded_int8.sharded_int8_block.launches, conway_block.conway_block.launches,
    mc_threefry.packed_metropolis_half.launches, mc_threefry.cell_uniforms.launches]), flush=True)
sys.exit(rc)
"""


# phase 15's profile of K6 and K7 in a fresh process: argv = the saved
# 16384^2 board (int32 words), the sweep the launches name, the side
P15_PROFILE = """
import json, sys
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from tpu_life_torch.kernels import mc_threefry as mct
from tpu_life_torch.mc import ising, packed, prng
dev, full = torch.device("cuda:0"), int(sys.argv[3])
thr = ising.acceptance_thresholds(2.27)
args = (0, 1, 0, int(sys.argv[2]), int(thr[3]), int(thr[4]))
def device_ms(launch, name, reps):
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events() if name in e.name]
    return sum(us) / len(us) / 1e3 if us else None
out = {}
for side in (4096, full):
    x = (torch.from_numpy(np.load(sys.argv[1])) if side == full else torch.from_numpy(
        packed.pack_board(prng.seeded_board(side, side, seed=1, device=dev).cpu().numpy())
        .view(np.int32).copy())).to(dev)
    y = torch.empty_like(x)
    out[f"k6_{side}"] = device_ms(lambda: mct.packed_metropolis_half(x, *args, width=side, out=y),
                                  "packed_metropolis_half_kernel", 10)
out["k7"] = device_ms(lambda: mct.cell_uniforms((full, full), 1, 0, 3, 0, device=dev),
                      "cell_uniforms_kernel", 5)
print("P15 " + json.dumps(out), flush=True)
"""


def phase15(ctx: dict) -> list[dict]:
    """Phase 15: the stochastic tier on the card — K7 and K6 held to their
    plain versions, the packed path held to the roll path at 16384^2, the
    entry points (``run --rule ising|noisy:``, ``--resume``, ``bench --mc``)
    against the numpy oracle's bytes, and both kernels timed beside their
    bounds.  Returns K6's and K7's rows of the kernels record."""
    import numpy as np
    import torch

    from tpu_life_torch.backends.base import get_backend, make_runner
    from tpu_life_torch.experiments import stripe_sweep
    from tpu_life_torch.io.codec import read_board
    from tpu_life_torch.kernels import conway_block as k5
    from tpu_life_torch.kernels import int8_tiled as kt
    from tpu_life_torch.kernels import mc_threefry as mct
    from tpu_life_torch.kernels import packed_stripe as ps
    from tpu_life_torch.kernels import sharded_int8 as k4
    from tpu_life_torch.kernels import sharded_stripe as k3
    from tpu_life_torch.mc import ising, packed, prng
    from tpu_life_torch.models.rules import get_rule

    dev, smi, cuda_ms = ctx["dev"], ctx["smi"], ctx["cuda_ms"]
    card = f"({smi})"
    clock = ctx["n_sm"] * ctx["sm_clock_mhz"] * 1e6  # SM clocks a second, all SMs
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    ising_rule = get_rule("ising")

    def counts() -> tuple[int, int]:
        return mct.packed_metropolis_half.launches, mct.cell_uniforms.launches

    def k1_to_k5() -> tuple[int, ...]:
        return (ps.packed_multi_step.launches + ps.packed_multi_step.diamond_launches,
                kt.int8_multi_step.launches, k3.sharded_stripe_block.launches,
                k4.sharded_int8_block.launches, k5.conway_block.launches)

    def zero() -> None:
        mct.packed_metropolis_half.launches = mct.cell_uniforms.launches = 0

    def counted(args: list[str], what: str):
        """``ctx['counted']`` with the K6 and K7 counts also set to 0 just
        before: (stdout lines, (K1, K2, K3, K4, K5, K6, K7), RunResult)."""
        zero()
        lines, got, res = ctx["counted"](args, what)
        return lines, (*got, k5.conway_block.launches, *counts()), res

    def bound(alu_ops: float, all_ops: float, n_bytes: float) -> tuple[float, str]:
        """Least ms for integer work and bytes: the logic ops and funnel
        shifts issue on the integer pipe only (64 a clock an SM), the adds
        also on the multiply-add pipe as IMAD (128 a clock an SM for both
        pipes, which K6's and K7's SASS use: see the IMAD counts); the bytes
        over the memory rate."""
        ops_ms = max(alu_ops / (INT_OPS_PER_CLOCK_PER_SM * clock),
                     all_ops / (2 * INT_OPS_PER_CLOCK_PER_SM * clock)) * 1e3
        mem_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")

    # word 0 of a draw: 18 rotates (SHF) and 19 xors (LOP3) on the integer
    # pipe, 29 adds on either (mct.ALU_OPS_PER_DRAW, mct.OPS_PER_DRAW); K6
    # adds a decided cell's select of thr3 or thr4 and one unsigned compare
    draw_alu, draw_all = mct.ALU_OPS_PER_DRAW, mct.OPS_PER_DRAW
    accept_ops = 2

    def words_of(board: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(packed.pack_board(board).view(np.int32).copy()).to(dev)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        absent = ["--input-file", str(tmp / "absent.txt"), "--config-file", str(tmp / "absent_grid.txt")]
        ref = tmp / "ref"
        ref.mkdir()
        with gzip.open(FIXTURES / "reference_data.txt.gz", "rb") as f:
            (ref / "data.txt").write_bytes(f.read())
        shutil.copy(FIXTURES / "reference_grid_size_data.txt", ref / "grid_size_data.txt")
        ref_files = ["--config-file", str(ref / "grid_size_data.txt"), "--input-file", str(ref / "data.txt")]
        hot = ["--rule", "ising", "--temperature", "2.27"]
        main_runs = {
            "ising, reference workload x 20": ([*ref_files, *hot, "--steps", "20"], (0, 0, 0, 0, 0, 40, 0)),
            "ising 512^2 x 64": ([*absent, *hot, "--size", "512", "--steps", "64", "--seed", "3"],
                                 (0, 0, 0, 0, 0, 128, 1)),
            "noisy:0.01/conway 512^2 x 64": ([*absent, "--rule", "noisy:0.01/conway", "--size", "512",
                                              "--steps", "64", "--seed", "3"], (0, 64, 0, 0, 0, 0, 65)),
        }
        # the entry points as child processes, on the card and on numpy,
        # all started now and read after the in-process checks
        children = {}
        for name, (args, _) in main_runs.items():
            for where, extra in (("cuda", []), ("numpy", ["--backend", "numpy"])):
                out = tmp / f"{len(children)}.txt"
                children[(name, where)] = (out, subprocess.Popen(
                    [sys.executable, "-c", P15_CHILD, "run", *args, *extra, "--output-file", str(out)],
                    cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        # numpy's Threefry stages the seeded boards meanwhile, in threads
        pool = ThreadPoolExecutor(4)
        seeded_cases = [(0.5, 2), (0.3, 2), (0.5, 3), (0.3, 3)]
        np_seeded = {case: pool.submit(
            lambda c: (time.perf_counter(), prng.seeded_board(MC_SEEDED, MC_SEEDED, c[0], states=c[1], seed=7),
                       time.perf_counter()), case) for case in seeded_cases}

        # (a) K7 against its plain version: the KAT vectors (counter word
        # c1 = step * NSUB + substream, c0 = the origin), then boards
        kat = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
               ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
               ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0))]
        t0 = time.perf_counter()
        k7_cases = k7_max_err = 0

        def draw_err(got: torch.Tensor, plain: torch.Tensor) -> int:
            """Max |draw difference| between two uint32 draw tensors."""
            nonlocal k7_max_err
            err = int((got.long() - plain.long()).abs().max().item()) if got.numel() else 0
            k7_max_err = max(k7_max_err, err)
            return err

        for key, ctr, want in kat:
            for word in (0, 1):
                args = ((1, 1), key[0], key[1], ctr[1] >> 2, ctr[1] & 3)
                got = mct.cell_uniforms(*args, origin=ctr[0], device=dev, word=word)
                plain = mct.cell_uniforms_plain(*args, origin=ctr[0], device=dev, word=word)
                if prng.as_u32(got.item()) != want[word] or draw_err(got, plain):
                    fail(f"K7 on the known-answer vector key {key} counter {ctr}, word {word}: "
                         f"{prng.as_u32(got.item()):#x}, want {want[word]:#x}")
                k7_cases += 1
        for shape in K7_SHAPES:
            for origin in K7_ORIGINS:
                for word in (0, 1):
                    got = mct.cell_uniforms(shape, 7, 9, 5, prng.SUB_NOISE, origin=origin, device=dev, word=word)
                    plain = mct.cell_uniforms_plain(shape, 7, 9, 5, prng.SUB_NOISE, origin=origin,
                                                    device=dev, word=word)
                    if draw_err(got, plain):
                        fail(f"K7 != plain: {shape[0]}x{shape[1]}, origin {origin}, word {word}")
                    k7_cases += 1
                    del got, plain
        print(f"K7 vs plain: {k7_cases} cases bit-identical (3 known-answer vectors x 2 words; "
              f"{', '.join(f'{h}x{w}' for h, w in K7_SHAPES)} at origins {K7_ORIGINS} x words 0, 1) "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

        # (b) K6 against its plain version, a sweep (two launches) at a time
        rng = np.random.default_rng(15)
        t0 = time.perf_counter()
        k6_cases = k6_max_err = 0

        def k6_case(board: np.ndarray, temp: float, origin: int, sweeps: int) -> None:
            nonlocal k6_cases, k6_max_err
            h, w = board.shape
            thr = ising.acceptance_thresholds(temp)
            x = y = words_of(board)
            for step in range(sweeps):
                for parity in (0, 1):
                    args = (parity, 11, 3, step, int(thr[3]), int(thr[4]))
                    x = mct.packed_metropolis_half(x, *args, width=w, origin=origin)
                    y = mct.packed_metropolis_half_plain(y, *args, width=w, origin=origin)
                err = int(bool((x ^ y).any()))  # max |spin difference|: 0 or 1
                k6_max_err = max(k6_max_err, err)
                if err:
                    fail(f"K6 != plain: {h}x{w}, T = {temp}, origin {origin}, sweep {step}")
                k6_cases += 1

        def k6_board(kind: str, h: int, w: int) -> np.ndarray:
            if kind == "random":
                return rng.integers(0, 2, size=(h, w), dtype=np.int8)
            if kind == "all-up":
                return np.ones((h, w), np.int8)
            if kind == "Neel":
                return ((np.arange(h)[:, None] + np.arange(w)[None, :]) & 1).astype(np.int8)
            board = np.zeros((h, w), np.int8)
            board[:, : w // 2] = 1
            return board

        for h, w in K6_SHAPES:
            for kind in K6_BOARDS:
                board = k6_board(kind, h, w)
                for temp in MC_TEMPS:
                    for origin in (0, 2**32 - h * w // 2, 2**33 + 6):
                        k6_case(board, temp, origin, 3)
        full_board = rng.integers(0, 2, size=(FULL, FULL), dtype=np.int8)
        for temp, origin in zip(MC_TEMPS, (0, 2**32 - FULL * FULL // 2, 2**33 + 6)):
            k6_case(full_board, temp, origin, 2)
        del full_board
        print(f"K6 vs plain: {k6_cases} sweeps bit-identical ({', '.join(f'{h}x{w}' for h, w in K6_SHAPES)} "
              f"x boards {', '.join(K6_BOARDS)} x T {MC_TEMPS} x origins 0 (narrow instance), across "
              f"2^32 and past 2^33 (wide), 3 sweeps each; {FULL}^2 random at T = 0, 2.27, 10 with one "
              f"origin each, 2 sweeps) ({time.perf_counter() - t0:.1f} s)", flush=True)

        # (c) the entry points' children: byte-equal to numpy's, launches counted
        main_launches = {}
        for name, (args, want) in main_runs.items():
            got_bytes = {}
            for where in ("cuda", "numpy"):
                out, proc = children[(name, where)]
                stdout, stderr = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    fail(f"phase 15 child run {name} ({where}): exited {proc.returncode}: {stderr[-3000:]}")
                launches = tuple(json.loads([ln for ln in stdout.splitlines() if ln.startswith("P15 ")][-1][4:]))
                if launches != (want if where == "cuda" else (0,) * 7):
                    fail(f"phase 15 child run {name} ({where}): (K1..K7) launches {launches}, want {want}")
                got_bytes[where] = out.read_bytes()
                if where == "cuda":
                    main_launches[name] = launches
            if got_bytes["cuda"] != got_bytes["numpy"]:
                fail(f"phase 15 run {name}: the card's output.txt differs from --backend numpy's")
        (tmp / "ising512.txt").write_bytes(
            children[("ising 512^2 x 64", "cuda")][0].read_bytes())
        print("phase 15 entry points as child processes of python -m tpu_life_torch, each byte-equal "
              "to its --backend numpy twin (also a child): " + "; ".join(
                  f"{name}: (K1..K7) launches {main_launches[name]}" for name in main_runs), flush=True)

        # (d) seeded boards on the card against numpy's
        t_card = {}
        for density, states in seeded_cases:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = prng.seeded_board(MC_SEEDED, MC_SEEDED, density, states=states, seed=7, device=dev)
            torch.cuda.synchronize()
            t_card[(density, states)] = time.perf_counter() - t0
            t_np0, want, t_np1 = np_seeded[(density, states)].result()
            if not np.array_equal(got.cpu().numpy(), want):
                fail(f"seeded_board {MC_SEEDED}^2 (density {density}, states {states}) on the card "
                     f"!= the numpy copy")
            np_seeded[(density, states)] = t_np1 - t_np0
        pool.shutdown()
        print(f"seeded_board {MC_SEEDED}^2 on the card (K7) equal to numpy's for densities 0.5, 0.3 "
              f"and states 2, 3: " + ", ".join(
                  f"({d}, {st}) card {t_card[(d, st)] * 1e3:.2f} ms, numpy {np_seeded[(d, st)]:.3f} s "
                  f"(4 in threads)" for d, st in seeded_cases), flush=True)

        # (e) 16384^2 Ising through the cuda Runner: packed (K6) against the roll path (K7)
        board = prng.seeded_board(FULL, FULL, seed=1, device=dev).cpu().numpy()
        runs = {}
        others = k1_to_k5()
        for bitpack in (True, False):
            runner = make_runner(get_backend("cuda", device=dev, bitpack=bitpack), board, ising_rule,
                                 seed=1, temperature=2.27)
            zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.advance(MC_SWEEPS)
            runner.sync()
            secs = time.perf_counter() - t0
            runs[bitpack] = (runner.route, counts(), secs, runner.fetch(), runner)
        (p_route, p_counts, p_secs, p_board, p_runner), (r_route, r_counts, r_secs, r_board, _) = (
            runs[True], runs[False])
        if (p_route, p_counts) != ("mc_packed", (2 * MC_SWEEPS, 0)):
            fail(f"{FULL}^2 ising through cuda: route {p_route!r}, (K6, K7) launches {p_counts}")
        if (r_route, r_counts) != ("mc_roll", (0, 2 * MC_SWEEPS)):
            fail(f"{FULL}^2 ising through cuda --no-bitpack: route {r_route!r}, (K6, K7) {r_counts}")
        if k1_to_k5() != others:
            fail(f"{FULL}^2 ising through cuda launched K1-K5: {others} -> {k1_to_k5()}")
        if not np.array_equal(p_board, r_board):
            fail(f"{FULL}^2 ising x {MC_SWEEPS}: the packed path (K6) != the roll path (K7)")
        mag = ising.magnetization(p_board)
        print(f"{FULL}^2 ising, T = 2.27, seed 1 (seeded on the card), {MC_SWEEPS} sweeps through the "
              f"cuda Runner: route mc_packed ({p_counts[0]} K6 launches) {p_secs:.3f} s "
              f"({FULL * FULL * MC_SWEEPS / p_secs:.4e} spin updates/s, host clock), route mc_roll "
              f"(--no-bitpack, {r_counts[1]} K7 launches) {r_secs:.3f} s "
              f"({FULL * FULL * MC_SWEEPS / r_secs:.4e}); boards bit-identical, |m| = {mag:.4f} "
              f"{card}", flush=True)
        k6_main_launches = p_counts[0]
        timing_board = p_runner.x.clone()  # the lattice after 256 sweeps at T = 2.27
        del runs, p_runner, board, r_board
        torch.cuda.empty_cache()

        # (f) snapshots and --resume, the refusal
        seeded = [*absent, *hot, "--size", "512", "--steps", "64", "--seed", "3"]
        snaps = tmp / "snaps"
        _, got, res = counted(["run", *seeded, "--snapshot-every", "32", "--snapshot-dir", str(snaps),
                               "--output-file", str(tmp / "s.txt")], "run --rule ising --snapshot-every 32")
        if got != (0, 0, 0, 0, 0, 128, 1) or (res.route, res.seed, res.temperature) != ("mc_packed", 3, 2.27):
            fail(f"run --rule ising --snapshot-every 32: launches {got}, route {res.route!r}, "
                 f"seed {res.seed}, temperature {res.temperature}")
        _, got, _ = counted(["run", *seeded, "--resume", str(snaps / "board_000000032.txt"),
                             "--output-file", str(tmp / "r.txt")], "run --rule ising --resume")
        want = (tmp / "ising512.txt").read_bytes()
        if got != (0, 0, 0, 0, 0, 64, 0) or (tmp / "s.txt").read_bytes() != want or \
                (tmp / "r.txt").read_bytes() != want:
            fail(f"--resume from step 32: launches {got}; the outputs differ from the full run's")
        rc = cli_main_rc(["run", *seeded, "--backend", "sharded", "--device", "cuda:0",
                          "--output-file", str(tmp / "x.txt")])
        if rc != 2:
            fail(f"run --backend sharded --rule ising exited {rc}, want 2")
        print("--snapshot-every 32 then --resume from step 32 (64 K6 launches): both outputs equal "
              "the full run's; --backend sharded --rule ising exits 2", flush=True)

    # (g) bench --mc at its defaults and at 16384^2
    bench_recs = []
    for flags in (["--mc-sizes", "64,128"],
                  ["--mc-size", str(FULL), "--mc-steps", "100", "--mc-base-steps", "20", "--mc-sizes", "64"]):
        lines, got, _ = counted(["bench", "--mc", *flags], "bench --mc " + " ".join(flags))
        rec = json.loads(lines[-1])
        print(lines[-1], flush=True)
        if (rec["metric"], rec["platform"], rec["packed"], rec["route"]) != (
                "mc_sweeps_per_sec", "cuda", True, "mc_packed") or not rec["value"] > 0 or not got[5] \
                or any(got[:5]):
            fail(f"bench --mc {' '.join(flags)}: {lines[-1]}; (K1..K7) {got}")
        bench_recs.append(rec)
    print(f"bench --mc: {bench_recs[0]['size']}^2 {bench_recs[0]['value']:.2f} sweeps/s "
          f"({bench_recs[0]['spin_updates_per_sec']:.4e} spin updates/s), {FULL}^2 "
          f"{bench_recs[1]['value']:.2f} sweeps/s ({bench_recs[1]['spin_updates_per_sec']:.4e}) "
          f"{card}", flush=True)

    # (h) K6 and K7 timed: CUDA events, the profiler's kernel records (in a
    # fresh child process: this long-lived one's profiles may hold no kernel
    # records, PERF.md §7), the plain versions, and the bounds of this input
    thr = ising.acceptance_thresholds(2.27)
    args = (0, 1, 0, MC_SWEEPS, int(thr[3]), int(thr[4]))
    k6_rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        saved = Path(tmp) / "board.npy"
        np.save(saved, timing_board.cpu().numpy())
        proc = subprocess.run([sys.executable, "-c", P15_PROFILE, str(saved), str(MC_SWEEPS), str(FULL)],
                              cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"phase 15 profile child exited {proc.returncode}: {proc.stderr[-3000:]}")
    device = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("P15 ")][-1][4:])

    def fmt_dev(v: float | None) -> str:
        return "not measured (no kernel records)" if v is None else f"{v:.4f}"

    for side in (4096, FULL):
        x = (timing_board if side == FULL
             else words_of(prng.seeded_board(side, side, seed=1, device=dev).cpu().numpy()))
        out = torch.empty_like(x)
        ms = cuda_ms(lambda: mct.packed_metropolis_half(x, *args, width=side, out=out), 20)
        dev_ms = device[f"k6_{side}"]
        plain_ms = cuda_ms(lambda: mct.packed_metropolis_half_plain(x, *args, width=side), 2)
        # the cells whose move the table decides (parity 0, dE > 0): the
        # function needs their draws only, and K6 hashes only those
        decided = stripe_sweep.decided_cells(x, side)
        n_words = x.numel()
        b_ms, b_by = bound(decided * (draw_alu + accept_ops) + 18 * n_words,
                           decided * (draw_all + accept_ops) + 18 * n_words, 2 * 4 * n_words)
        all_ms, _ = bound(side * side // 2 * (draw_alu + accept_ops),
                          side * side // 2 * (draw_all + accept_ops), 0)
        instance = "narrow" if mct.narrow_launch(side, side, 0) else "wide"
        k6_rows[side] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             decided=decided, all_cells_bound_ms=all_ms, instance=instance)
        what = (f"the board after {MC_SWEEPS} sweeps at T = 2.27" if side == FULL
                else "the seeded board of seed 1")
        print(f"K6 {side}^2 half-sweep (parity 0, {what}), {instance} instance, hashing the "
              f"{decided} draws a launch of the cells a draw decides against {side * side // 2} "
              f"active cells ({decided / (side * side // 2):.1%}): {ms:.4f} ms a launch by CUDA "
              f"events, {fmt_dev(dev_ms)} device, plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms "
              f"({b_by}: {draw_alu + accept_ops} integer-pipe and {draw_all + accept_ops} integer "
              f"ops a decided cell, 18 a word), {b_ms / ms:.1%} of it"
              + ("" if dev_ms is None else f" ({b_ms / dev_ms:.1%} by device time)")
              + f"; every active cell hashed: {all_ms:.4f} ms {card}", flush=True)
        del out
    del timing_board
    n = FULL * FULL
    k7_args = ((FULL, FULL), 1, 0, 3, prng.SUB_EVEN)
    k7_ms = cuda_ms(lambda: mct.cell_uniforms(*k7_args, device=dev), 10)
    k7_dev = device["k7"]
    k7_plain = cuda_ms(lambda: mct.cell_uniforms_plain(*k7_args, device=dev), 1)
    k7_bound, k7_by = bound(n * draw_alu, n * draw_all, 4 * n)
    print(f"K7 {FULL}^2 word 0: {k7_ms:.4f} ms by CUDA events, {fmt_dev(k7_dev)} device, plain "
          f"{k7_plain:.3f} ms; bound {k7_bound:.4f} ms ({k7_by}: {draw_alu} integer-pipe and "
          f"{draw_all} integer ops a draw; {4 * n / 2**30:.0f} GiB written "
          f"{4 * n / HBM_BYTES_PER_S * 1e3:.4f} ms), {k7_bound / k7_ms:.1%} of it {card}; "
          f"phase 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    k6 = k6_rows[FULL]
    return [{
        "name": "packed_metropolis_half",
        "route": "cuda",
        "source": "tpu_life_torch/csrc/mc_threefry.cu",
        "replaces": "tpu_life/mc/packed.py:208",
        "launches": k6_main_launches,
        "max_abs_err": k6_max_err,
        "equal_to_plain": k6_max_err == 0,
        "shape": [FULL, FULL],
        "ms": k6["ms"],
        "kernel_ms": k6["ms"],
        "device_ms": k6["device_ms"],
        "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"],
        "bound_by": k6["bound_by"],
        "library_ms": None,
        "decided_cells": k6["decided"],
        "all_cells_bound_ms": k6["all_cells_bound_ms"],
        "instance": k6["instance"],
        "ms_4096": k6_rows[4096]["ms"],
        "device_ms_4096": k6_rows[4096]["device_ms"],
        "bound_ms_4096": k6_rows[4096]["bound_ms"],
        "cli_launches": {name: got[5] for name, got in main_launches.items()},
        **ctx["instances"][K6_NARROW],
        "wide_instance": ctx["instances"][K6_WIDE],
    }, {
        "name": "cell_uniforms",
        "route": "cuda",
        "source": "tpu_life_torch/csrc/mc_threefry.cu",
        "replaces": "tpu_life/mc/prng.py:155",
        "launches": main_launches["noisy:0.01/conway 512^2 x 64"][6],
        "max_abs_err": k7_max_err,
        "equal_to_plain": k7_max_err == 0,
        "shape": [FULL, FULL],
        "ms": k7_ms,
        "kernel_ms": k7_ms,
        "device_ms": k7_dev,
        "plain_ms": k7_plain,
        "bound_ms": k7_bound,
        "bound_by": k7_by,
        "library_ms": None,
        "roll_launches": r_counts[1],
        "cli_launches": {name: got[6] for name, got in main_launches.items()},
        **ctx["instances"]["K7 cell_uniforms_kernel"],
    }]


# phase 16's profile of K1's batch mode in a fresh process: argv = the
# batch shapes' sides; each side's 8 random packed boards, every slot at a
# full chunk's budget, one chunk of 16 steps (chunk_plan's launches, their
# device times summed); and 8 single-board K1 runs of 16 steps, launches of
# depth 8, on the same boards (their total a rep).  The same child times
# phase 17's batch modes (one process start for both phases): K6's on 8
# copies of the sweep's seeded board at the grid's temperatures (parity 0,
# offset 0), 8 single-board K6 launches on the same boards, and K7's at
# 8 x the roll side^2
P16_PROFILE = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from tpu_life_torch.kernels import packed_batch as kb, packed_stripe as ps
from tpu_life_torch.models.rules import get_rule
dev, rule = torch.device("cuda:0"), get_rule("conway")
def device_ms(launch, name, reps):
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events() if name in e.name]
    return (sum(us) / reps / 1e3, len(us) // reps) if us else (None, 0)
out = {}
for side in map(int, sys.argv[1:]):
    g = torch.Generator(device=dev).manual_seed(side)
    x = torch.randint(-2**31, 2**31 - 1, (8, side, side // 32), generator=g, dtype=torch.int32,
                      device=dev)
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    steps = torch.full((8,), 16, dtype=torch.int32, device=dev)
    plan = kb.chunk_plan(rule, (side, side), 16, 8, ps.sm_count(0))
    def chunk():
        src = x
        for i, lc in enumerate(plan):
            src = kb.packed_batch_multi_step(src, steps, rule, (side, side), lc.k, out=bufs[i %% 2],
                                             offset=lc.offset)
    out[f"batch_{side}"] = device_ms(chunk, "packed_batch", 20)
    def singles():
        for s in range(8):
            ps.packed_multi_step(x[s], rule, (side, side), 16, block_steps=8, scratch=bufs[0][s])
    out[f"single_{side}"] = device_ms(singles, "packed_stripe_kernel", 10)
import numpy as np
from tpu_life_torch.kernels import mc_threefry as mct
from tpu_life_torch.mc import ising, packed, prng
side, seed, roll = %d, %d, %d
temps = [1.5 + 1.5 * i / 7 for i in range(8)]
thr = np.stack([ising.acceptance_thresholds(t) for t in temps])
k0, k1 = prng.key_halves(seed)
def i32(v):
    return torch.tensor(v, dtype=torch.int32, device=dev)
state = prng.SlotState(i32([k0] * 8), i32([k1] * 8), i32([0] * 8),
                       torch.from_numpy(thr.view(np.int32).copy()).to(dev), i32([256] * 8))
board = prng.seeded_board(side, side, seed=seed, device=dev).cpu().numpy()
x = torch.from_numpy(np.stack([packed.pack_board(board).view(np.int32)] * 8)).to(dev)
y = torch.empty_like(x)
out["k6_batch"] = device_ms(lambda: mct.packed_metropolis_half_batch(x, 0, state, width=side, out=y),
                            "packed_metropolis_batch_kernel", 20)[0]
def k6_singles():
    for s in range(8):
        mct.packed_metropolis_half(x[s], 0, k0, k1, 0, int(thr[s, 3]), int(thr[s, 4]), width=side,
                                   out=y[s])
out["k6_singles"] = device_ms(k6_singles, "packed_metropolis_half_kernel", 10)[0]
out["k7_batch"] = device_ms(lambda: mct.cell_uniforms_batch((roll, roll), state, 0),
                            "cell_uniforms_batch_kernel", 20)[0]
print("P16 " + json.dumps(out), flush=True)
""" % (P17_SIDE, P17_SEED, P17_ROLL_SIDE)


def phase16(ctx: dict) -> dict:
    """Phase 16: the serving tier on the card — K1's batch mode held to its
    plain version and timed beside its bound and 8 single-board K1
    launches, the serve mix through ``serve`` on every backend and pump
    against the numpy oracle's bytes, the K2 keys' sessions through K2 per
    slot, the governor's estimate beside the allocator's peak, the
    reference workload as a served request, a mega-board session on
    ``mesh:2x2`` of the card, and a Lenia batch.  Returns K1's batch
    mode's row of the kernels record, with K2's serve launches under
    ``k2_serve_launches`` for K2's row and its child's profile of phase
    17's batch modes under ``mc_batch_device``."""
    import numpy as np
    import torch

    from tpu_life_torch import cli
    from tpu_life_torch.backends.base import get_backend, make_runner
    from tpu_life_torch.io.codec import encode_board, read_board, write_board
    from tpu_life_torch.kernels import int8_tiled as kt
    from tpu_life_torch.kernels import packed_batch as kb
    from tpu_life_torch.kernels import packed_stripe as ps
    from tpu_life_torch.mc.prng import seeded_board
    from tpu_life_torch.models import lenia
    from tpu_life_torch.models.rules import get_rule
    from tpu_life_torch.ops import bitlife
    from tpu_life_torch.ops.reference import run_np
    from tpu_life_torch.serve import ServeConfig, SimulationService, governor
    from tpu_life_torch.serve.engine import BatchEngine, SlotLoopEngine

    dev, smi = ctx["dev"], ctx["smi"]
    card = f"({smi})"
    int_ops_per_s = ctx["n_sm"] * INT_OPS_PER_CLOCK_PER_SM * ctx["sm_clock_mhz"] * 1e6
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    rng = np.random.default_rng(16)
    conway = get_rule("conway")

    def events_ms(launch, reps: int) -> float:
        launch()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def packed_batch_of(boards: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.stack([bitlife.pack_np(b).view(np.int32) for b in boards])).to(dev)

    # (a) K1's batch mode against its plain version, launch by launch over
    # a chunk (chunk_plan's launches: one on narrow rows, launches of depth
    # 8 on wide ones), with budgets 0, 1, k-1, k, k+1, the chunk, 3 and past
    # it: every segment width and both sides of each boundary at 97 rows
    # (the four rules in turn, chunks of 16 and 32), the serve mix's shape,
    # a wide board, the reference workload's and an R2 diamond's
    cases = [(P16_RULES[i % len(P16_RULES)], (97, w), chunk)
             for i, w in enumerate(P16_WIDTHS) for chunk in (P16_CHUNK, 2 * P16_CHUNK)]
    cases += [("conway", (512, 512), P16_CHUNK), ("conway", (4096, 4096), P16_CHUNK),
              ("highlife", (1500, 500), P16_CHUNK), ("R2,C2,S2..4,B2..3,NN", (1000, 333), P16_CHUNK)]
    checked = batch_max_err = 0
    layouts = set()
    for spec, (h, w), chunk in cases:
        rule = get_rule(spec)
        plan = kb.chunk_plan(rule, (h, w), chunk, 8, ctx["n_sm"])
        k = plan[0].k
        budgets = [0, 1, k - 1, k, k + 1, chunk, 3, 100]
        boards = (rng.random((8, h, w)) < 0.35).astype(np.int8)
        boards[0, 0, :] = boards[1, :, 0] = boards[2, -1, :] = boards[3, :, -1] = 1  # edges live
        x = packed_batch_of(boards)
        steps = torch.tensor(budgets, dtype=torch.int32, device=dev)
        kern, plain = x, x
        for launch in plan:
            kern = kb.packed_batch_multi_step(kern, steps, rule, (h, w), launch.k,
                                              out=torch.empty_like(x), offset=launch.offset)
            plain = kb.packed_batch_multi_step_plain(plain, steps, rule, (h, w), launch.k,
                                                     out=torch.empty_like(x), offset=launch.offset)
            err = int(bool((kern ^ plain).any()))  # max |cell difference|: 0 or 1
            batch_max_err = max(batch_max_err, err)
            if err:
                fail(f"phase 16 (a): K1's batch mode differs from its plain version: {spec} "
                     f"8x{h}x{w}, launch {launch}, budgets {budgets}")
            checked += 1
            layouts.add("segments" if launch.tiles.seg else "strips")
        for s, n in enumerate(budgets):  # and the slots to independent runs
            want = run_np(boards[s], rule, min(n, chunk)) if h * w <= 1 << 20 else None
            if want is not None and not np.array_equal(bitlife.unpack_np(
                    kern[s].cpu().numpy().view(np.uint32), w), want):
                fail(f"phase 16 (a): {spec} {h}x{w} slot {s} (budget {n}) differs from run_np")
    if layouts != {"segments", "strips"}:
        fail(f"phase 16 (a): the cases ran the layouts {sorted(layouts)}, want both")
    print(f"phase 16 (a): K1's batch mode bit-identical to its plain version in {checked} launches "
          f"(widths {', '.join(map(str, P16_WIDTHS))} at 97 rows, chunks of {P16_CHUNK} and "
          f"{2 * P16_CHUNK}, rules {', '.join(P16_RULES)} in turn; conway 8x512^2 and 8x4096^2, "
          f"highlife 8x1500x500, R2 NN 8x1000x333; budgets 0, 1, k-1, k, k+1, the chunk, 3, 100; "
          f"every slot of the small boards equal to run_np)", flush=True)

    # timed: a chunk of 16 steps (chunk_plan's launches), every slot at a
    # full chunk's budget, by CUDA events; its plain version; 8 single-board
    # K1 runs of 16 steps; the device times from the profiler in a fresh
    # child; the bound of a chunk
    rows = {}
    for side in P16_SIDES:
        g = torch.Generator(device=dev).manual_seed(side)
        x = torch.randint(-2**31, 2**31 - 1, (8, side, side // 32), generator=g, dtype=torch.int32,
                          device=dev)
        bufs = [torch.empty_like(x), torch.empty_like(x)]
        steps = torch.full((8,), P16_CHUNK, dtype=torch.int32, device=dev)
        plan = kb.chunk_plan(conway, (side, side), P16_CHUNK, 8, ctx["n_sm"])

        def chunk(step):
            src = x
            for i, launch in enumerate(plan):
                src = step(src, launch, bufs[i % 2])
            return src

        ms = events_ms(lambda: chunk(lambda src, lc, o: kb.packed_batch_multi_step(
            src, steps, conway, (side, side), lc.k, out=o, offset=lc.offset)), 20)
        plain_ms = events_ms(lambda: chunk(lambda src, lc, o: kb.packed_batch_multi_step_plain(
            src, steps, conway, (side, side), lc.k, out=o, offset=lc.offset)), 2)

        def singles():
            for s in range(8):
                ps.packed_multi_step(x[s], conway, (side, side), P16_CHUNK,
                                     block_steps=BLOCK_STEPS, scratch=bufs[0][s])
        single_ms = events_ms(singles, 10)
        n_words = 8 * side * (side // 32)
        mem_ms = 2 * n_words * 4 / HBM_BYTES_PER_S * 1e3
        ops_ms = ps.logic_ops_per_word_step(conway) * n_words * P16_CHUNK / int_ops_per_s * 1e3
        bound_ms, bound_by = (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")
        rows[side] = dict(ms=ms, plain_ms=plain_ms, single_ms=single_ms, bound_ms=bound_ms,
                          bound_by=bound_by, launches=len(plan),
                          tiles=[tuple(lc.tiles) for lc in plan], ks=[lc.k for lc in plan])
    proc = subprocess.run([sys.executable, "-c", P16_PROFILE, *map(str, P16_SIDES)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"phase 16 profile child exited {proc.returncode}: {proc.stderr[-3000:]}")
    device = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("P16 ")][-1][4:])

    def fmt_dev(v) -> str:
        return "not measured (no kernel records)" if v is None else f"{v:.4f}"

    for side, r in rows.items():
        r["device_ms"], n_rec = device[f"batch_{side}"]
        r["single_device_ms"], n_single = device[f"single_{side}"]
        print(f"K1's batch mode, conway 8x{side}^2, a chunk of {P16_CHUNK} steps, every slot "
              f"stepping: {r['launches']} launch(es) of k = {r['ks']} (tiles, rows a warp or "
              f"segment, segment lanes: {r['tiles']}); {r['ms']:.4f} ms a chunk by CUDA events, "
              f"device {fmt_dev(r['device_ms'])} ({n_rec} kernel records a chunk); bound "
              f"{r['bound_ms']:.5f} ms a chunk ({r['bound_by']}: "
              f"{ps.logic_ops_per_word_step(conway)} logic ops a word a step over every slot's "
              f"words, or each word read and written once); plain {r['plain_ms']:.3f} ms; 8 "
              f"single-board K1 runs of {P16_CHUNK} steps {r['single_ms']:.4f} ms by events, "
              f"device {fmt_dev(r['single_device_ms'])} ({n_single} kernel records a rep) {card}",
              flush=True)
    torch.cuda.empty_cache()

    def serve_cli(args: list[str]) -> tuple[int, dict]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(args)
        return rc, json.loads(buf.getvalue().strip().splitlines()[-1])

    # (b) the serve mix through `serve`: 32 sessions of 512^2 Conway x 128
    # steps (8 distinct boards), capacity 8, chunk 16, half the sessions
    # queued at once (--max-queue 16) and the rest admitted as the pump
    # runs, on every backend and pump; each result equal to the numpy
    # oracle's bytes.  A run lasts about a tenth of a second on the card,
    # so each card backend and pump runs P16_REPEATS times and the rates
    # are read as their median and range; the numpy oracle runs once
    mix = {}
    main_launches = None
    per_chunk = len(kb.chunk_plan(conway, (P16_SIDE, P16_SIDE), P16_CHUNK, 8, ctx["n_sm"]))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        oracle = []
        for i in range(8):
            b = seeded_board(P16_SIDE, P16_SIDE, seed=100 + i)
            write_board(tmp / f"b{i}.txt", b)
            oracle.append(encode_board(run_np(b, conway, P16_STEPS)))
        spool = tmp / "mix.jsonl"
        spool.write_text("".join(json.dumps({
            "input_file": str(tmp / f"b{i % 8}.txt"), "height": P16_SIDE, "width": P16_SIDE,
            "steps": P16_STEPS, "rule": "conway", "seed": 0}) + "\n" for i in range(P16_SESSIONS)))
        for backend in ("cuda", "sharded", "numpy"):
            for pump in ("pipelined", "sync"):
                runs = []
                for rep in range(1 if backend == "numpy" else P16_REPEATS):
                    out = tmp / f"out_{backend}_{pump}_{rep}"
                    kb.packed_batch_multi_step.launches = BatchEngine.dispatched = 0
                    rc, summary = serve_cli([
                        "serve", "--requests", str(spool), "--output-dir", str(out),
                        "--serve-backend", backend, "--capacity", "8", "--chunk-steps",
                        str(P16_CHUNK), "--max-queue", str(P16_SESSIONS // 2),
                        *(["--sync-pump"] if pump == "sync" else [])])
                    launches, chunks = kb.packed_batch_multi_step.launches, BatchEngine.dispatched
                    if rc != 0 or summary["done"] != P16_SESSIONS or summary["written"] != P16_SESSIONS:
                        fail(f"phase 16 (b) serve {backend} {pump}: rc {rc}, {summary}")
                    for i in range(P16_SESSIONS):
                        if (out / f"s{i:06d}.txt").read_bytes() != oracle[i % 8]:
                            fail(f"phase 16 (b) serve {backend} {pump}: session {i} differs from "
                                 f"the numpy oracle's bytes")
                    shutil.rmtree(out)
                    if backend == "cuda" and not (chunks and launches == per_chunk * chunks):
                        fail(f"phase 16 (b) serve cuda {pump}: {launches} K1 batch launches over "
                             f"{chunks} chunks, want chunk_plan's {per_chunk} a chunk")
                    if backend != "cuda" and launches:
                        fail(f"phase 16 (b) serve {backend} {pump}: {launches} K1 batch launches")
                    if backend == "cuda" and pump == "pipelined" and rep == 0:
                        main_launches = launches
                    el = summary["elapsed_s"]
                    runs.append(dict(
                        sessions_per_s=summary["sessions_per_sec"], rounds=summary["rounds"],
                        rounds_per_s=summary["rounds"] / el if el > 0 else 0.0,
                        occupancy=summary["batch_occupancy_mean"],
                        idle=summary["device_idle_s"] / el if el > 0 else 0.0,
                        elapsed_s=el, launches=launches, chunks=chunks))
                mix[(backend, pump)] = runs
    print(f"phase 16 (b): the serve mix ({P16_SESSIONS} x {P16_SIDE}^2 conway x {P16_STEPS}, "
          f"capacity 8, chunk {P16_CHUNK}, --max-queue {P16_SESSIONS // 2}) through serve, every "
          f"result equal to the numpy oracle's bytes; median [min, max] of {P16_REPEATS} runs on "
          f"the card's backends, 1 on numpy {card}:", flush=True)

    def spread(runs: list[dict], name: str, fmt: str) -> str:
        v = sorted(r[name] for r in runs)
        med = v[len(v) // 2]
        return f"{med:{fmt}}" if len(v) == 1 else f"{med:{fmt}} [{v[0]:{fmt}}, {v[-1]:{fmt}}]"

    for (backend, pump), runs in mix.items():
        m = runs[0]
        per = f"{m['launches'] / m['chunks']:.2f}" if m["chunks"] else "n/a"
        print(f"  {backend:8s} {pump:9s}: {spread(runs, 'sessions_per_s', '.2f')} sessions/s, "
              f"{spread(runs, 'rounds_per_s', '.2f')} rounds/s ({m['rounds']} rounds, "
              f"{spread(runs, 'elapsed_s', '.4f')} s), occupancy {m['occupancy']:.3f}, device "
              f"idle {spread(runs, 'idle', '.4f')} of the run, K1 batch launches "
              f"{m['launches']} over {m['chunks']} batch chunks ({per} a chunk)", flush=True)

    # (b') the keys K1 does not take go to K2 on cuda, one Runner a slot:
    # 8 sessions of 512^2 brians_brain x P16_K2_STEPS under both pumps, each
    # equal to the numpy oracle's bytes; K2 launches 2 a slot a chunk (K2's
    # depth at radius 1 is 8, the chunk 16), K1's batch mode none
    brain = get_rule("brians_brain")
    k2_depth = kt.clamp_block_steps(brain, BLOCK_STEPS)
    k2_want = 8 * (P16_K2_STEPS // P16_CHUNK) * -(-P16_CHUNK // k2_depth)
    k2_runs = {}
    k2_serve_launches = None
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        oracle = []
        for i in range(8):
            b = rng.integers(0, 3, (P16_SIDE, P16_SIDE)).astype(np.int8)
            write_board(tmp / f"b{i}.txt", b)
            oracle.append(encode_board(run_np(b, brain, P16_K2_STEPS)))
        spool = tmp / "k2.jsonl"
        spool.write_text("".join(json.dumps({
            "input_file": str(tmp / f"b{i}.txt"), "height": P16_SIDE, "width": P16_SIDE,
            "steps": P16_K2_STEPS, "rule": "brians_brain", "seed": 0}) + "\n" for i in range(8)))
        for pump in ("pipelined", "sync"):
            out = tmp / f"out_{pump}"
            kb.packed_batch_multi_step.launches = kt.int8_multi_step.launches = 0
            rc, summary = serve_cli([
                "serve", "--requests", str(spool), "--output-dir", str(out), "--capacity", "8",
                "--chunk-steps", str(P16_CHUNK), *(["--sync-pump"] if pump == "sync" else [])])
            launches = (kb.packed_batch_multi_step.launches, kt.int8_multi_step.launches)
            if rc != 0 or summary["done"] != 8 or launches != (0, k2_want):
                fail(f"phase 16 (b') serve brians_brain {pump}: rc {rc}, (K1 batch, K2) launches "
                     f"{launches}, want (0, {k2_want}); {summary}")
            for i in range(8):
                if (out / f"s{i:06d}.txt").read_bytes() != oracle[i]:
                    fail(f"phase 16 (b') serve brians_brain {pump}: session {i} differs from the "
                         f"numpy oracle's bytes")
            if pump == "pipelined":
                k2_serve_launches = launches[1]
            k2_runs[pump] = summary["elapsed_s"]
    svc = SimulationService(ServeConfig(backend="cuda", capacity=2, chunk_steps=P16_CHUNK))
    try:
        svc.submit(np.zeros((64, 64), np.int8), "brians_brain", 1)
        svc.drain()
        engines = [type(e) for e in svc.scheduler.engines.values()]
    finally:
        svc.close()
    if engines != [SlotLoopEngine]:
        fail(f"phase 16 (b'): a brians_brain key on cuda built {engines}, want the K2 slot loop")
    print(f"phase 16 (b'): 8 x {P16_SIDE}^2 brians_brain x {P16_K2_STEPS} on cuda (capacity 8, chunk "
          f"{P16_CHUNK}) through K2 per slot, {k2_want} K2 launches a run and no K1 batch launch, "
          f"every result equal to the numpy oracle's bytes; serve took "
          f"{k2_runs['pipelined']:.4f} s pipelined, {k2_runs['sync']:.4f} s sync {card}", flush=True)

    # the governor's estimate beside the allocator's peak for one cuda engine
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    svc = SimulationService(ServeConfig(backend="cuda", capacity=8, chunk_steps=P16_CHUNK))
    try:
        for i in range(8):
            svc.submit(seeded_board(P16_SIDE, P16_SIDE, seed=100 + i), "conway", 32)
        svc.drain()
        (key,) = svc.scheduler.engines
        estimate = governor.estimate_engine_bytes(key, 8)
    finally:
        svc.close()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"phase 16 governor: one cuda engine of 8 x {P16_SIDE}^2 conway (route k1_batch): "
          f"estimate {estimate} bytes, torch.cuda.max_memory_allocated {peak} bytes over the "
          f"baseline ({peak / estimate:.3f} of the estimate)", flush=True)

    # (c) the reference workload as a served request: submit, then serve
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with gzip.open(FIXTURES / "reference_data.txt.gz", "rb") as f:
            (tmp / "data.txt").write_bytes(f.read())
        shutil.copy(FIXTURES / "reference_grid_size_data.txt", tmp / "grid_size_data.txt")
        spool = str(tmp / "ref.jsonl")
        if cli_main_rc(["submit", "--requests", spool, "--input-file", str(tmp / "data.txt"),
                        "--config-file", str(tmp / "grid_size_data.txt"),
                        "--output-file", str(tmp / "output.txt")]) != 0:
            fail("phase 16 (c): submit of the reference workload failed")
        kb.packed_batch_multi_step.launches = BatchEngine.dispatched = 0
        rc = cli_main_rc(["serve", "--requests", spool, "--output-dir", str(tmp / "out")])
        ref_launches, ref_chunks = kb.packed_batch_multi_step.launches, BatchEngine.dispatched
        raw = (tmp / "output.txt").read_bytes() if (tmp / "output.txt").exists() else b""
        ref_plan = len(kb.chunk_plan(conway, (1500, 500), P16_CHUNK, 8, ctx["n_sm"]))
        if rc != 0 or len(raw) != GOLDEN_BYTES or hashlib.sha256(raw).hexdigest() != GOLDEN_SHA \
                or not ref_launches or ref_launches != ref_plan * ref_chunks:
            fail(f"phase 16 (c): served reference workload rc {rc}, {len(raw)} bytes, "
                 f"{ref_launches} K1 batch launches over {ref_chunks} chunks (chunk_plan: "
                 f"{ref_plan} a chunk); want the golden sha256")
    print(f"phase 16 (c): submit + serve of the reference workload: golden sha256, "
          f"{ref_launches} K1 batch launches over {ref_chunks} chunks", flush=True)

    # (d) a mega-board session of FULL^2 on mesh:2x2 of the card (a budget
    # the board's batch overflows), held to a one-card run's bytes
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        spool = str(tmp / "mega.jsonl")
        cli_main_rc(["submit", "--requests", spool, "--size", str(FULL), "--steps",
                     str(P16_MEGA_STEPS), "--seed", "5", "--input-file", str(tmp / "absent.txt"),
                     "--output-file", str(tmp / "mega.txt")])
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["serve", "--requests", spool, "--output-dir", str(tmp / "out"),
                           "--mesh-devices", "4", "--memory-budget-bytes", str(1 << 30)])
        mega_s = time.perf_counter() - t0
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        if rc != 0 or summary["done"] != 1:
            fail(f"phase 16 (d): mega-board serve rc {rc}: {summary}")
        board = seeded_board(FULL, FULL, seed=5, device=dev).cpu().numpy()
        runner = make_runner(get_backend("cuda"), board, conway)
        runner.advance(P16_MEGA_STEPS)
        want = runner.fetch()
        del runner
        got = read_board(tmp / "mega.txt", FULL, FULL)
        if not np.array_equal(got, want):
            fail("phase 16 (d): the mesh:2x2 mega-board differs from the one-card run")
    print(f"phase 16 (d): a {FULL}^2 conway x {P16_MEGA_STEPS} session served on mesh:2x2 of the "
          f"card (--mesh-devices 4, budget 1 GiB), equal to the cuda backend's run; serve took "
          f"{mega_s:.1f} s {card}", flush=True)
    torch.cuda.empty_cache()

    # (e) a lenia:orbium 512^2 batch on cuda (route ops), allclose to the
    # numpy oracle at the Lenia tier's tolerance
    orbium = get_rule("lenia:orbium")
    boards = [lenia.seeded_board(P16_SIDE, P16_SIDE, seed=s) for s in range(4)]
    budgets = [8, 3, 8, 5]
    svc = SimulationService(ServeConfig(backend="cuda", capacity=8, chunk_steps=4))
    try:
        sids = [svc.submit(b, "lenia:orbium", n) for b, n in zip(boards, budgets)]
        svc.drain()
        routes = {e.route for e in svc.scheduler.engines.values()}
        err = max(float(np.abs(svc.result(sid) - lenia.run_np(b, orbium, n)).max())
                  for sid, b, n in zip(sids, boards, budgets))
    finally:
        svc.close()
    if routes != {"ops"} or not err <= lenia.FLOAT_ATOL:
        fail(f"phase 16 (e): lenia:orbium batch routes {routes}, max error {err}")
    print(f"phase 16 (e): lenia:orbium 4 x {P16_SIDE}^2 (budgets {budgets}) on cuda, route ops: max "
          f"abs error {err:.3e} against the numpy oracle (<= {lenia.FLOAT_ATOL}); phase 16 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    small, big = rows[P16_SIDES[0]], rows[P16_SIDES[-1]]
    return {
        "name": "packed_batch_multi_step",
        "route": "cuda",
        "source": "tpu_life_torch/csrc/packed_stripe.cu",
        "replaces": "tpu_life/serve/engine.py:453",
        "launches": main_launches,
        "max_abs_err": batch_max_err,
        "equal_to_plain": batch_max_err == 0,
        "rule": "conway",
        "shape": [8, P16_SIDE, P16_SIDE],
        "steps_per_chunk": P16_CHUNK,
        "launches_per_chunk": small["launches"],
        "ms": small["ms"],
        "kernel_ms": small["ms"],
        "device_ms": small["device_ms"],
        "plain_ms": small["plain_ms"],
        "bound_ms": small["bound_ms"],
        "bound_by": small["bound_by"],
        "library_ms": None,
        "tiles": small["tiles"],
        "single_board_ms": small["single_ms"],
        "single_board_device_ms": small["single_device_ms"],
        "launches_per_chunk_4096": big["launches"],
        "ms_4096": big["ms"],
        "device_ms_4096": big["device_ms"],
        "plain_ms_4096": big["plain_ms"],
        "bound_ms_4096": big["bound_ms"],
        "single_board_ms_4096": big["single_ms"],
        "chunks": mix[("cuda", "pipelined")][0]["chunks"],
        "reference_launches": ref_launches,
        "serve_mix": {f"{b} {p}": {k: [r[k] for r in runs] for k in (
            "sessions_per_s", "rounds_per_s", "occupancy", "idle")}
                      for (b, p), runs in mix.items()},
        "k2_serve_launches": k2_serve_launches,
        "mc_batch_device": {k: device[k] for k in ("k6_batch", "k6_singles", "k7_batch")},
        **ctx["instances"][K1_SEGMENT],
        "strip_instance": {"instance": K1_BATCH, **ctx["instances"][K1_BATCH]},
    }


# phase 17's children: ``python -m tpu_life_torch`` run as ``__main__``,
# then printing the launch counts of K6 and K7 and of their batch modes
P17_CHILD = """
import json, runpy, sys
from tpu_life_torch.kernels import mc_threefry as mct
sys.argv = ["tpu_life_torch", *sys.argv[1:]]
rc = 0
try:
    runpy.run_module("tpu_life_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    rc = e.code or 0
print("P17 " + json.dumps({
    "k6": mct.packed_metropolis_half.launches, "k7": mct.cell_uniforms.launches,
    "k6_batch": mct.packed_metropolis_half_batch.launches,
    "k7_batch": mct.cell_uniforms_batch.launches}), flush=True)
sys.exit(rc)
"""

def phase17(ctx: dict) -> list[dict]:
    """Phase 17: the stochastic serving tier on the card — K6's and K7's
    batch modes held to their plain versions, the sweep at full width as a
    child process (K6's batch mode only, every session equal to the
    single-board Runner), its ``--no-bitpack`` twin through K7's batch mode,
    a noisy spool and the reference workload as an ``ising`` session
    through ``serve``, and a spilled session resumed in a fresh service.
    Returns the batch modes' rows of the kernels record."""
    import numpy as np
    import torch

    from tpu_life_torch import cli
    from tpu_life_torch.backends.base import get_backend, make_runner
    from tpu_life_torch.experiments import stripe_sweep
    from tpu_life_torch.io.codec import encode_board, read_board
    from tpu_life_torch.kernels import mc_threefry as mct
    from tpu_life_torch.mc import ising, packed, prng
    from tpu_life_torch.models.rules import get_rule
    from tpu_life_torch.serve import ServeConfig, SimulationService
    from tpu_life_torch.serve.engine import BatchEngine
    from tpu_life_torch.serve.spill import read_spill_sessions

    dev, smi = ctx["dev"], ctx["smi"]
    card = f"({smi})"
    clock = ctx["n_sm"] * ctx["sm_clock_mhz"] * 1e6  # SM clocks a second, all SMs
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    rng = np.random.default_rng(17)
    ising_rule = get_rule("ising")

    def counts() -> dict[str, int]:
        return {"k6": mct.packed_metropolis_half.launches, "k7": mct.cell_uniforms.launches,
                "k6_batch": mct.packed_metropolis_half_batch.launches,
                "k7_batch": mct.cell_uniforms_batch.launches}

    def zero() -> None:
        mct.packed_metropolis_half.launches = mct.cell_uniforms.launches = 0
        mct.packed_metropolis_half_batch.launches = mct.cell_uniforms_batch.launches = 0
        BatchEngine.dispatched = 0

    def i32(values) -> torch.Tensor:
        return torch.tensor([prng.as_i32(v) for v in values], dtype=torch.int32, device=dev)

    def slot_state(temps, seeds, counters, budgets) -> prng.SlotState:
        keys = [prng.key_halves(int(v)) for v in seeds]
        thr = np.stack([ising.acceptance_thresholds(t) for t in temps]).view(np.int32)
        return prng.SlotState(i32([k[0] for k in keys]), i32([k[1] for k in keys]), i32(counters),
                              torch.from_numpy(thr.copy()).to(dev), i32(budgets))

    def events_ms(launch, reps: int) -> float:
        launch()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def bound(alu_ops: float, all_ops: float, n_bytes: float) -> tuple[float, str]:
        """Phase 15's: the integer-pipe ops at 64 a clock an SM, all integer
        ops over both pipes at 128, the bytes over the memory rate."""
        ops_ms = max(alu_ops / (INT_OPS_PER_CLOCK_PER_SM * clock),
                     all_ops / (2 * INT_OPS_PER_CLOCK_PER_SM * clock)) * 1e3
        mem_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")

    # (a) the batch modes against their plain versions: capacities 1, 3 and
    # 8; per-slot seeds, temperatures (T = 0 among them) and start counters
    # (past 2^31, and 2^32 - 5, which wraps within a chunk); budgets below,
    # at and past the chunk, frozen slots among live ones; K6 launch by
    # launch over the sweeps of a chunk of 16 on each side of every budget's
    # end (P17_OFFSETS; at 4096^2 the first two sweeps and the last), at
    # origins 0, across 2^32 and past it on the small
    # boards (the wide instance); K7 at offsets 0, 1 and 15 in three
    # substreams
    zero()
    k6_cases = k7_cases = batch_err = 0
    for n in P17_CAPACITIES:
        temps = [(2.27, 0.0, 10.0, 1.5, 3.0, 2.0, 0.5, 2.6)[i] for i in range(n)]
        seeds = [int(v) for v in rng.integers(-2**40, 2**40, n)]
        counters = [(2**31 + 12345, 2**32 - 5, 3, 0, 2**31 - 1, 77, 2**31, 1)[i] for i in range(n)]
        budgets = [(P17_CHUNK + 1, 0, 1, P17_CHUNK - 1, P17_CHUNK, 3, 100, 7)[i] for i in range(n)]
        state = slot_state(temps, seeds, counters, budgets)
        for h, w in P17_K6_SHAPES:
            full = h * w >= P17_SIDE ** 2
            x = torch.from_numpy(np.stack([packed.pack_board(
                (rng.random((h, w)) < 0.5).astype(np.int8)).view(np.int32) for _ in range(n)])).to(dev)
            offsets = (0, 1, P17_CHUNK - 1) if full else P17_OFFSETS
            for origin in ((0,) if full or h * w > 2**20 else P17_K6_ORIGINS):
                kern = plain = x
                for t in offsets:
                    for parity in (0, 1):
                        kern = mct.packed_metropolis_half_batch(kern, parity, state, width=w,
                                                                offset=t, origin=origin)
                        plain = mct.packed_metropolis_half_batch_plain(plain, parity, state, width=w,
                                                                       offset=t, origin=origin)
                        err = int(not torch.equal(kern, plain))
                        batch_err = max(batch_err, err)
                        k6_cases += 1
                        if err:
                            fail(f"phase 17 (a): K6's batch mode differs from its plain version: "
                                 f"{n} x {h}x{w}, origin {origin}, offset {t}, parity {parity}")
            del x, kern, plain
        for h, w in P17_K7_SHAPES:
            for substream in (prng.SUB_EVEN, prng.SUB_ODD, prng.SUB_NOISE):
                for t in (0, 1, P17_CHUNK - 1):
                    got = mct.cell_uniforms_batch((h, w), state, substream, offset=t)
                    want = mct.cell_uniforms_batch_plain((h, w), state, substream, offset=t)
                    err = int(not torch.equal(got, want))
                    batch_err = max(batch_err, err)
                    k7_cases += 1
                    if err:
                        fail(f"phase 17 (a): K7's batch mode differs from its plain version: "
                             f"{n} x {h}x{w}, substream {substream}, offset {t}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    got = counts()
    if got["k6_batch"] != k6_cases or got["k7_batch"] != k7_cases:
        fail(f"phase 17 (a): launch counts {got}, want {k6_cases} and {k7_cases}")
    print(f"phase 17 (a): K6's batch mode bit-identical to its plain version in {k6_cases} "
          f"launches (capacities {', '.join(map(str, P17_CAPACITIES))}; "
          f"{', '.join(f'{h}x{w}' for h, w in P17_K6_SHAPES)}; origins 0, 2^32 - 1000, 2^33 + 5 on "
          f"the boards up to 512^2: both instances; sweeps {P17_OFFSETS} of a chunk of {P17_CHUNK}; T 2.27, 0, 10, "
          f"...; counters past 2^31 and wrapping; budgets {P17_CHUNK + 1}, 0, 1, {P17_CHUNK - 1}, "
          f"{P17_CHUNK}, 3, 100, 7), K7's in {k7_cases} launches ("
          f"{', '.join(f'{h}x{w}' for h, w in P17_K7_SHAPES)}; substreams 0, 1, 2; offsets 0, 1, "
          f"{P17_CHUNK - 1}); launches counted {got}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (b) the sweep at full width, a child process: 8 sessions of
        # 4096^2 x 256 at the grid's temperatures, one CompileKey built
        # once, every sweep two launches of K6's batch mode (32 a chunk of
        # 16, 16 chunks) and nothing else; each session equal to the
        # single-board Runner on the same staged board (K6 alone)
        sweep_args = ["sweep", "--size", str(P17_SIDE), "--steps", str(P17_STEPS), "--temps",
                      P17_TEMPS, "--seed", str(P17_SEED), "--output-dir", str(tmp / "sweep")]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", P17_CHILD, *sweep_args], cwd=tmp, env=env,
                              capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"phase 17 (b): the sweep exited {proc.returncode}: {proc.stderr[-3000:]}")
        no_demotion("phase 17 (b): the sweep child", ctx["watch"], proc.stderr)
        lines = proc.stdout.splitlines()
        rec = json.loads([ln for ln in lines if ln.startswith('{"mode": "sweep"')][-1])
        sweep_counts = json.loads([ln for ln in lines if ln.startswith("P17 ")][-1][4:])
        want_k6 = 2 * P17_STEPS
        if list(rec["compile_counts"].values()) != [1] or rec["done"] != 8 or sweep_counts != {
                "k6": 0, "k7": 1, "k6_batch": want_k6, "k7_batch": 0}:
            fail(f"phase 17 (b): compile_counts {rec['compile_counts']}, done {rec['done']}, "
                 f"launches {sweep_counts}; want one key built once, 8 done, {want_k6} K6 batch "
                 f"launches and the staging's one K7 launch")
        board = prng.seeded_board(P17_SIDE, P17_SIDE, seed=P17_SEED, device=dev).cpu().numpy()
        backend = get_backend("cuda")
        for sess in rec["sessions"]:
            runner = make_runner(backend, board, ising_rule, seed=P17_SEED,
                                 temperature=sess["temperature"])
            runner.advance(P17_STEPS)
            want = runner.fetch()
            got = read_board(tmp / "sweep" / f"{sess['session']}.txt", P17_SIDE, P17_SIDE)
            if runner.route != "mc_packed" or not np.array_equal(got, want):
                fail(f"phase 17 (b): session {sess['session']} (T = {sess['temperature']}) differs "
                     f"from the single-board Runner's board (route {runner.route})")
        del runner, want, got
        print(f"phase 17 (b): sweep {' '.join(sweep_args[1:-2])} as a child: exit 0, compile_counts "
              f"{list(rec['compile_counts'].values())}, {sweep_counts['k6_batch']} K6 batch launches "
              f"({2 * P17_CHUNK} a chunk of {P17_CHUNK}) and no other kernel's but the staging's K7; "
              f"elapsed_s {rec['elapsed_s']:.4f} ({rec['rounds']} rounds; the child {child_s:.1f} s); "
              f"every session equal to the cuda Runner's board at its temperature (route mc_packed); "
              f"magnetizations " + ", ".join(f"T {s['temperature']:.4f}: {s['magnetization']:.4f}"
                                               for s in rec["sessions"]) + f" {card}", flush=True)

        # timed: K6's batch mode at 8 x 4096^2 (the sweep's board in every
        # slot, the grid's temperatures, parity 0) by CUDA events, beside its
        # plain version, 8 single-board K6 launches and its bound; K7's
        # batch mode at 8 x 1024^2; device times from the profiler records
        # of phase 16's fresh child (P16_PROFILE)
        device = ctx["device"]
        temps = [float(s["temperature"]) for s in rec["sessions"]]
        state = slot_state(temps, [P17_SEED] * 8, [0] * 8, [P17_STEPS] * 8)
        k0, k1 = prng.key_halves(P17_SEED)
        one = torch.from_numpy(packed.pack_board(board).view(np.int32).copy()).to(dev)
        x = one.expand(8, *one.shape).contiguous()
        y = torch.empty_like(x)
        k6_ms = events_ms(lambda: mct.packed_metropolis_half_batch(x, 0, state, width=P17_SIDE,
                                                                   out=y), 20)
        k6_plain = events_ms(lambda: mct.packed_metropolis_half_batch_plain(x, 0, state,
                                                                            width=P17_SIDE), 2)

        def singles():
            for s, t in enumerate(temps):
                thr = ising.acceptance_thresholds(t)
                mct.packed_metropolis_half(x[s], 0, k0, k1, 0, int(thr[3]), int(thr[4]),
                                           width=P17_SIDE, out=y[s])
        singles_ms = events_ms(singles, 10)
        # the decided cells differ by temperature only in which ones accept:
        # the same board in every slot, the same cells decided
        decided = 8 * stripe_sweep.decided_cells(one, P17_SIDE)
        n_words = x.numel()
        draw_alu, draw_all, accept_ops = mct.ALU_OPS_PER_DRAW, mct.OPS_PER_DRAW, 2
        k6_bound, k6_by = bound(decided * (draw_alu + accept_ops) + 18 * n_words,
                                decided * (draw_all + accept_ops) + 18 * n_words, 2 * 4 * n_words)
        del x, y, one
        rstate = slot_state(temps, [P17_SEED] * 8, [0] * 8, [P17_ROLL_STEPS] * 8)
        roll_shape = (P17_ROLL_SIDE, P17_ROLL_SIDE)
        k7_ms = events_ms(lambda: mct.cell_uniforms_batch(roll_shape, rstate, 0), 20)
        k7_plain = events_ms(lambda: mct.cell_uniforms_batch_plain(roll_shape, rstate, 0), 2)
        n_draws = 8 * P17_ROLL_SIDE ** 2
        k7_bound, k7_by = bound(n_draws * draw_alu, n_draws * draw_all, 4 * n_draws)
        torch.cuda.empty_cache()

        def fmt_dev(v) -> str:
            return "not measured (no kernel records)" if v is None else f"{v:.4f}"

        print(f"K6's batch mode, a half-sweep of 8 x {P17_SIDE}^2 (the sweep's seeded board in every "
              f"slot, its 8 temperatures, parity 0), hashing {decided} decided cells: {k6_ms:.4f} ms "
              f"by CUDA events, device {fmt_dev(device['k6_batch'])}; 8 single-board K6 launches "
              f"{singles_ms:.4f} ms by events, device {fmt_dev(device['k6_singles'])}; plain "
              f"{k6_plain:.3f} ms; bound {k6_bound:.4f} ms ({k6_by}: {draw_alu + accept_ops} "
              f"integer-pipe ops a decided cell, 18 a word, at {INT_OPS_PER_CLOCK_PER_SM} a clock an "
              f"SM), {k6_bound / k6_ms:.1%} of it"
              + ("" if device["k6_batch"] is None else
                 f" ({k6_bound / device['k6_batch']:.1%} by device time)") + f" {card}", flush=True)
        print(f"K7's batch mode, word 0 of 8 x {P17_ROLL_SIDE}^2: {k7_ms:.4f} ms by CUDA events, device "
              f"{fmt_dev(device['k7_batch'])}; plain {k7_plain:.3f} ms; bound {k7_bound:.4f} ms "
              f"({k7_by}: {draw_alu} integer-pipe ops a draw), {k7_bound / k7_ms:.1%} of it {card}",
              flush=True)

        def cli_run(args: list[str], what: str) -> tuple[dict, dict]:
            """One in-process CLI call with every count set to 0 just before
            and read just after: (its summary record, the counts)."""
            zero()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(args)
            got = {**counts(), "chunks": BatchEngine.dispatched}
            if rc != 0:
                fail(f"phase 17 {what} exited {rc}")
            return json.loads(buf.getvalue().strip().splitlines()[-1]), got

        # (c) the roll path: the same sweep at 1024^2 x 32 packed (K6's batch
        # mode) and with --no-bitpack (K7's, two launches a sweep), byte for
        # byte
        roll_args = ["sweep", "--size", str(P17_ROLL_SIDE), "--steps", str(P17_ROLL_STEPS),
                     "--temps", P17_TEMPS, "--seed", str(P17_SEED)]
        prec, pc = cli_run([*roll_args, "--output-dir", str(tmp / "packed")], "(c) packed sweep")
        rrec, rc_ = cli_run([*roll_args, "--no-bitpack", "--output-dir", str(tmp / "roll")],
                            "(c) --no-bitpack sweep")
        if (pc["k6_batch"], pc["k7_batch"]) != (2 * P17_ROLL_STEPS, 0) or \
                (rc_["k6_batch"], rc_["k7_batch"]) != (0, 2 * P17_ROLL_STEPS):
            fail(f"phase 17 (c): launches packed {pc}, roll {rc_}")
        for s in prec["sessions"]:
            name = f"{s['session']}.txt"
            if (tmp / "packed" / name).read_bytes() != (tmp / "roll" / name).read_bytes():
                fail(f"phase 17 (c): the --no-bitpack session {name} differs from the packed one")
        roll_launches = rc_["k7_batch"]
        print(f"phase 17 (c): sweep at {P17_ROLL_SIDE}^2 x {P17_ROLL_STEPS}: packed {pc['k6_batch']} K6 "
              f"batch launches, --no-bitpack {roll_launches} K7 batch launches, every session "
              f"byte-equal; elapsed_s {prec['elapsed_s']:.4f} packed, {rrec['elapsed_s']:.4f} roll "
              f"{card}", flush=True)

        # (d) a noisy spool (16 seeded sessions, distinct seeds, capacity 8)
        # through serve under both pumps, and the reference workload as an
        # ising session at T = 2.27: each byte-equal to the single-board
        # cuda Runner with the same seed
        noisy = get_rule(P17_NOISY)
        spool = tmp / "noisy.jsonl"
        spool.write_text("".join(json.dumps({
            "height": P17_NOISY_SIDE, "width": P17_NOISY_SIDE, "steps": P17_NOISY_STEPS,
            "rule": P17_NOISY, "seed": 100 + i}) + "\n" for i in range(P17_NOISY_SESSIONS)))
        oracle = []
        for i in range(P17_NOISY_SESSIONS):
            b = prng.seeded_board(P17_NOISY_SIDE, P17_NOISY_SIDE, seed=100 + i)
            runner = make_runner(backend, b, noisy, seed=100 + i)
            runner.advance(P17_NOISY_STEPS)
            oracle.append(encode_board(runner.fetch()))
        noisy_runs = {}
        for pump in ("pipelined", "sync"):
            out = tmp / f"noisy_{pump}"
            summary, got = cli_run(["serve", "--requests", str(spool), "--output-dir", str(out),
                                    "--capacity", "8", "--chunk-steps", str(P17_CHUNK),
                                    *(["--sync-pump"] if pump == "sync" else [])],
                                   f"(d) serve {P17_NOISY} {pump}")
            if summary["done"] != P17_NOISY_SESSIONS or got["k6_batch"] or not got["chunks"] or \
                    got["k7_batch"] != P17_CHUNK * got["chunks"]:
                fail(f"phase 17 (d) serve {P17_NOISY} {pump}: {summary}, launches {got}")
            for i in range(P17_NOISY_SESSIONS):
                if (out / f"s{i:06d}.txt").read_bytes() != oracle[i]:
                    fail(f"phase 17 (d) serve {P17_NOISY} {pump}: session {i} differs from the "
                         f"cuda Runner's bytes")
            noisy_runs[pump] = (summary, got)
        ref = tmp / "ref"
        ref.mkdir()
        with gzip.open(FIXTURES / "reference_data.txt.gz", "rb") as f:
            (ref / "data.txt").write_bytes(f.read())
        shutil.copy(FIXTURES / "reference_grid_size_data.txt", ref / "grid_size_data.txt")
        ref_spool = str(tmp / "ref.jsonl")
        if cli_main_rc(["submit", "--requests", ref_spool, "--input-file", str(ref / "data.txt"),
                        "--config-file", str(ref / "grid_size_data.txt"), "--rule", "ising",
                        "--temperature", "2.27", "--output-file", str(ref / "output.txt")]) != 0:
            fail("phase 17 (d): submit of the reference workload as an ising session failed")
        summary, ref_got = cli_run(["serve", "--requests", ref_spool, "--output-dir",
                                    str(tmp / "ref_out")], "(d) serve the reference workload")
        h, w, steps = (int(v) for v in (ref / "grid_size_data.txt").read_text().split()[:3])
        runner = make_runner(backend, read_board(ref / "data.txt", h, w), ising_rule, seed=0,
                             temperature=2.27)
        runner.advance(steps)
        if (ref / "output.txt").read_bytes() != encode_board(runner.fetch()) or \
                ref_got["k6_batch"] != 2 * P17_CHUNK * ref_got["chunks"]:
            fail(f"phase 17 (d): the reference workload's ising session differs from the cuda "
                 f"Runner's bytes, or launches {ref_got}")
        ns, ng = noisy_runs["pipelined"]
        print(f"phase 17 (d): {P17_NOISY_SESSIONS} x {P17_NOISY_SIDE}^2 {P17_NOISY} x "
              f"{P17_NOISY_STEPS} (seeds 100-{99 + P17_NOISY_SESSIONS}, capacity 8, chunk "
              f"{P17_CHUNK}) through serve, every result equal to the cuda Runner's bytes: "
              + "; ".join(f"{pump} {g['k7_batch']} K7 batch launches over {g['chunks']} chunks, "
                          f"{s['sessions_per_sec']:.2f} sessions/s, elapsed {s['elapsed_s']:.4f} s"
                          for pump, (s, g) in noisy_runs.items())
              + f"; the reference workload ({h}x{w} x {steps}) served as ising at T = 2.27: "
              f"{ref_got['k6_batch']} K6 batch launches over {ref_got['chunks']} chunks, equal to "
              f"the Runner's bytes {card}", flush=True)

        # (e) spill and resume: an ising session spilled mid-run, resumed in
        # a fresh service at the spilled step, equal to the uninterrupted
        # session
        board = prng.seeded_board(P17_SPILL_SIDE, P17_SPILL_SIDE, seed=9, device=dev).cpu().numpy()
        session = dict(seed=9, temperature=2.27)
        svc = SimulationService(ServeConfig(backend="cuda", capacity=2, chunk_steps=P17_CHUNK,
                                            spill_dir=str(tmp / "spill"), spill_every=1))
        try:
            svc.submit(board, "ising", P17_SPILL_STEPS, **session)
            for _ in range(3):
                svc.pump()
            (rec_s,), corrupt, _ = read_spill_sessions(tmp / "spill")
        finally:
            svc.close()
        if corrupt or not 0 < rec_s.step < P17_SPILL_STEPS:
            fail(f"phase 17 (e): spilled at step {rec_s.step}, corrupt {corrupt}")
        results = []
        for kwargs in (dict(board=rec_s.board, steps=rec_s.remaining, start_step=rec_s.step),
                       dict(board=board, steps=P17_SPILL_STEPS, start_step=0)):
            svc = SimulationService(ServeConfig(backend="cuda", capacity=2, chunk_steps=P17_CHUNK))
            try:
                sid = svc.submit(kwargs["board"], rec_s.rule, kwargs["steps"], seed=rec_s.seed,
                                 temperature=rec_s.temperature, start_step=kwargs["start_step"])
                svc.drain()
                results.append(svc.result(sid))
            finally:
                svc.close()
        if not np.array_equal(results[0], results[1]):
            fail("phase 17 (e): the resumed session differs from the uninterrupted one")
    print(f"phase 17 (e): an ising {P17_SPILL_SIDE}^2 x {P17_SPILL_STEPS} session (seed 9, T = 2.27) "
          f"spilled at step {rec_s.step} and resumed in a fresh service, equal to the uninterrupted "
          f"session; phase 17 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return [{
        "name": "packed_metropolis_half_batch",
        "route": "cuda",
        "source": "tpu_life_torch/csrc/mc_threefry.cu",
        "replaces": "tpu_life/mc/engine.py:620",
        "launches": sweep_counts["k6_batch"],
        "max_abs_err": batch_err,
        "equal_to_plain": batch_err == 0,
        "shape": [8, P17_SIDE, P17_SIDE],
        "ms": k6_ms,
        "kernel_ms": k6_ms,
        "device_ms": device["k6_batch"],
        "plain_ms": k6_plain,
        "bound_ms": k6_bound,
        "bound_by": k6_by,
        "library_ms": None,
        "decided_cells": decided,
        "single_board_ms": singles_ms,
        "single_board_device_ms": device["k6_singles"],
        "reference_launches": ref_got["k6_batch"],
        "sweep_elapsed_s": rec["elapsed_s"],
        **ctx["instances"][K6_BATCH],
    }, {
        "name": "cell_uniforms_batch",
        "route": "cuda",
        "source": "tpu_life_torch/csrc/mc_threefry.cu",
        "replaces": "tpu_life/mc/engine.py:446",
        "launches": ng["k7_batch"],
        "max_abs_err": batch_err,
        "equal_to_plain": batch_err == 0,
        "shape": [8, P17_ROLL_SIDE, P17_ROLL_SIDE],
        "ms": k7_ms,
        "kernel_ms": k7_ms,
        "device_ms": device["k7_batch"],
        "plain_ms": k7_plain,
        "bound_ms": k7_bound,
        "bound_by": k7_by,
        "library_ms": None,
        "roll_launches": roll_launches,
        **ctx["instances"][K7_BATCH],
    }]


def phase18(ctx: dict) -> dict:
    """Phase 18: the native board codec and the autotuner on the card.
    (a) the codec built from ``csrc/codec.cpp`` decodes and encodes phase
    14's 16384^2 board (``gen --seed 5``) byte-equal to the numpy codec,
    host ms median of 3; (b) ``tune --size 16384 --rule conway`` measured
    into a temporary cache, every ``cuda`` and ``sharded --local-kernel
    cuda`` candidate feasible, with K1 and K3 launched; (c) ``run --backend
    tuned`` of that board x 256 as a child, natively and under
    ``TPU_LIFE_NATIVE=0``: resolved from the cache, the pick's kernel
    launched, the output phase 14 (a)'s bytes; (d) the reference workload
    served through ``--serve-backend tuned`` at the golden sha256 with no
    trial measured; (e) ``bench --backend tuned`` at 16384^2 resolving from
    the cache.  Returns the K1 and K3 launches of (b) and of (c)'s native
    run, and (c)'s pick; (d)'s K1 batch-mode launches and pick."""
    import statistics

    import numpy as np

    from tpu_life_torch import autotune
    from tpu_life_torch.autotune import cost_model
    from tpu_life_torch.io import codec, native
    from tpu_life_torch.kernels import packed_batch as kb
    from tpu_life_torch.models.rules import get_rule

    counted, spans_ms, smi = ctx["counted"], ctx["spans_ms"], ctx["smi"]
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "TPU_LIFE_NATIVE"):
        env.pop(var, None)
    saved = {v: os.environ.get(v) for v in ("TPU_LIFE_NATIVE", autotune.cache.ENV_VAR)}

    def set_env(var: str, value: str | None) -> None:
        if value is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = value

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cache_file = tmp / "autotune.json"
        env[autotune.cache.ENV_VAR] = str(cache_file)
        try:
            set_env("TPU_LIFE_NATIVE", None)
            set_env(autotune.cache.ENV_VAR, str(cache_file))
            files = ["--config-file", str(tmp / "grid_size_data.txt"), "--input-file",
                     str(tmp / "data.txt")]
            # (a) the codec: a fresh g++ build into the temporary directory
            # timed (the run's own library was built at its first use), then
            # both paths on the same bytes
            from tpu_life_torch.kernels import _build

            native.build()
            root, _build.BUILD_ROOT = _build.BUILD_ROOT, tmp / "codec_build"
            try:
                t0 = time.perf_counter()
                native.nativelib.build(native.SOURCE)
                build_s = time.perf_counter() - t0
            finally:
                _build.BUILD_ROOT = root
            counted(["gen", "--height", str(FULL), "--width", str(FULL), "--steps",
                     str(FULL_STEPS), "--seed", "5", *files], f"gen {FULL}^2")
            raw = (tmp / "data.txt").read_bytes()
            timing, boards = {}, {}
            for path, switch in (("native", None), ("numpy", "0")):
                set_env("TPU_LIFE_NATIVE", switch)
                dec, enc = [], []
                for _ in range(3):
                    t0 = time.perf_counter()
                    board = codec.decode_board(raw, FULL, FULL)
                    t1 = time.perf_counter()
                    again = codec.encode_board(board)
                    t2 = time.perf_counter()
                    if again != raw:
                        fail(f"phase 18 (a): the {path} codec's encode differs from the file")
                    dec.append((t1 - t0) * 1e3)
                    enc.append((t2 - t1) * 1e3)
                timing[path] = (statistics.median(dec), statistics.median(enc))
                boards[path] = board
            set_env("TPU_LIFE_NATIVE", None)
            if not np.array_equal(boards["native"], boards["numpy"]):
                fail("phase 18 (a): native and numpy decodes differ")
            del board, again, boards
            print(f"phase 18 (a), the native codec (card: {smi}; host {os.cpu_count()} CPUs, "
                  f"{native.nativelib.default_threads()} threads): a fresh g++ build {build_s:.2f} s from "
                  f"{native.SOURCE.relative_to(ROOT)}; {FULL}^2 board (gen --seed 5) decoded and "
                  f"encoded byte-equal to the numpy codec; host ms, median of 3: decode native "
                  f"{timing['native'][0]:.1f}, numpy {timing['numpy'][0]:.1f}; encode native "
                  f"{timing['native'][1]:.1f}, numpy {timing['numpy'][1]:.1f}", flush=True)

            # (b) the tuner, measured into the temporary cache
            t0 = time.perf_counter()
            lines, got, _ = counted(["tune", "--size", str(FULL), "--rule", "conway"],
                                    f"tune --size {FULL}")
            tune_s = time.perf_counter() - t0
            summary = json.loads(lines[-1])
            table = {}
            for ln in lines:
                m = re.match(r"\s+\[\d+/\d+\] (.+? stencil=\S+)\s+(\S+)", ln)
                if m:
                    sps = None if m.group(2) == "infeasible:" else float(m.group(2))
                    table[m.group(1).strip()] = (sps, ln)
            kernel_cands = [d for d in table if d.startswith("cuda ") or "local_kernel=cuda" in d]
            bad = [table[d][1].strip() for d in kernel_cands if table[d][0] is None]
            if len(kernel_cands) != 10 or bad:
                fail(f"phase 18 (b): {len(kernel_cands)} cuda and K3 candidates, infeasible: {bad}")
            if summary["source"] != "measured" or summary["cache_file"] != str(cache_file):
                fail(f"phase 18 (b): tune summary {summary}")
            if got[0] <= 0 or got[2] <= 0:
                fail(f"phase 18 (b): (K1, K2, K3, K4) launches {got}: K1 and K3 must launch")
            rule = get_rule("conway")
            key = autotune.tune_key_for(rule, (FULL, FULL))
            cands = autotune.enumerate_candidates(key, shape=(FULL, FULL))
            pick = cost_model.choose(key, cands)
            best = autotune.TunedConfig.from_dict(summary["best"])
            ok = sorted((v[0], d) for d, v in table.items() if v[0] is not None)
            print(f"phase 18 (b), tune --size {FULL} --rule conway ({tune_s:.1f} s; "
                  f"{summary['candidates']} candidates, {summary['infeasible']} infeasible; "
                  f"launches (K1, K2, K3, K4) {got}); the table, s/step:", flush=True)
            for ln in lines[:-1]:
                print(f"  {ln.strip()}", flush=True)
            pick_sps = table[pick.describe()][0]
            print(f"  winner {best.describe()} at {summary['seconds_per_step']:.4e} s/step; "
                  f"runner-up {ok[1][1]} at {ok[1][0]:.4e} ({ok[1][0] / ok[0][0]:.3f}x); "
                  f"the cost model's pick {pick.describe()} at {pick_sps:.4e} s/step, "
                  f"{pick_sps / ok[0][0]:.3f}x the best", flush=True)
            tune_launches = got

            # (c) run --backend tuned as a child, native and numpy codec
            want_kernel = {"cuda": 0, "sharded": 2}.get(best.backend)
            runs = {}
            for path, extra in (("native", {}), ("numpy", {"TPU_LIFE_NATIVE": "0"})):
                out, trace = tmp / f"{path}.txt", tmp / f"{path}.json"
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, "-c", P14_CHILD, "run", *files, "--backend", "tuned",
                     "--trace-events", str(trace), "--output-file", str(out)],
                    cwd=tmp, env=dict(env, **extra), capture_output=True, text=True, timeout=600)
                wall = time.perf_counter() - t0
                if proc.returncode != 0:
                    fail(f"phase 18 (c) {path}: exited {proc.returncode}: {proc.stderr[-3000:]}")
                rec = json.loads([ln for ln in proc.stdout.splitlines()
                                  if ln.startswith("P14 ")][-1][4:])
                total = [ln for ln in proc.stdout.splitlines() if ln.startswith("Total time = ")]
                picks = [e["args"] for e in json.loads(trace.read_text())["traceEvents"]
                         if e.get("name") == "autotune-pick"]
                spans = spans_ms(trace)
                sha = hashlib.sha256(out.read_bytes()).hexdigest()
                out.unlink()
                if len(picks) != 1 or picks[0]["source"] != "cache" or \
                        picks[0]["pick"] != best.describe():
                    fail(f"phase 18 (c) {path}: autotune-pick {picks}, want {best.describe()} "
                         f"from the cache")
                if "autotune-resolve" not in spans or len(total) != 1:
                    fail(f"phase 18 (c) {path}: spans {sorted(spans)}, {len(total)} Total lines")
                if want_kernel is None or rec["launches"][want_kernel] <= 0:
                    fail(f"phase 18 (c) {path}: pick {best.describe()}, (K1, K2, K3, K4) "
                         f"launches {rec['launches']}")
                if sha != ctx["a_sha"]:
                    fail(f"phase 18 (c) {path}: output differs from phase 14 (a)'s")
                runs[path] = dict(spans=spans, total=total[0].split("=")[1].strip(), wall=wall,
                                  launches=rec["launches"])
            print(f"phase 18 (c), run --backend tuned {FULL}^2 x {FULL_STEPS} from the file (a "
                  f"child each; pick {best.describe()} from the cache; output byte-equal to phase "
                  f"14 (a), sha256 {ctx['a_sha'][:12]}):", flush=True)
            for path, r in runs.items():
                sp = r["spans"]
                print(f"  {path} codec: Total time {r['total']} s, wall {r['wall']:.2f} s, "
                      f"launches (K1, K2, K3, K4) {tuple(r['launches'])}, spans ms: "
                      + ", ".join(f"{n} {sp[n]:.1f}" for n in
                                  ("autotune-resolve", "backend-build", "stage", "drive",
                                   "gather", "output-write") if n in sp), flush=True)

            # (d) serving through tuned: the reference workload, no trial
            with gzip.open(FIXTURES / "reference_data.txt.gz", "rb") as f:
                (tmp / "ref.txt").write_bytes(f.read())
            shutil.copy(FIXTURES / "reference_grid_size_data.txt", tmp / "ref_grid.txt")
            spool = tmp / "spool.jsonl"
            autotune.reset_trial_count()
            counted(["submit", "--input-file", str(tmp / "ref.txt"), "--config-file",
                     str(tmp / "ref_grid.txt"), "--requests", str(spool),
                     "--output-file", str(tmp / "served.txt")], "submit the reference workload")
            kb.packed_batch_multi_step.launches = 0
            lines, served_counts, _ = counted(
                ["serve", "--serve-backend", "tuned", "--requests", str(spool), "--output-dir",
                 str(tmp / "serve_out")], "serve --serve-backend tuned")
            served_batch = kb.packed_batch_multi_step.launches
            ctx["golden"](tmp / "served.txt", "phase 18 (d) served through tuned")
            if autotune.trial_count() != 0:
                fail(f"phase 18 (d): serving measured {autotune.trial_count()} trials")
            ref_key = autotune.tune_key_for(rule, (1500, 500))
            ref_pick, ref_source = autotune.resolve(ref_key, shape=(1500, 500))
            if sum(served_counts) + served_batch == 0:
                fail(f"phase 18 (d): pick {ref_pick.describe()} served with no kernel launched")
            print(f"phase 18 (d), the reference workload served through --serve-backend tuned: "
                  f"golden sha256, key {ref_key.id()} -> {ref_pick.describe()} ({ref_source}), "
                  f"launches (K1, K2, K3, K4) {served_counts}, K1's batch mode {served_batch}, "
                  f"0 trials measured", flush=True)

            # (e) bench through the cache
            lines, bench_counts, _ = counted(["bench", "--backend", "tuned", "--size", str(FULL)],
                                             f"bench --backend tuned --size {FULL}")
            rec = json.loads(lines[-1])
            print(lines[-1], flush=True)
            if rec["tuned_source"] != "cache" or rec["backend"] != best.backend or \
                    not rec["value"] > 0:
                fail(f"phase 18 (e): bench record {rec}")
        finally:
            for var, value in saved.items():
                set_env(var, value)
    print(f"phase 18 (e), bench --backend tuned --size {FULL}: tuned_source cache, backend "
          f"{rec['backend']}, {rec['value']:.4e} cells/s, launches (K1, K2, K3, K4) "
          f"{bench_counts}; phase 18 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    run = runs["native"]["launches"]
    return {"k1": tune_launches[0], "k3": tune_launches[2], "run_k1": run[0], "run_k3": run[2],
            "pick": best.describe(), "served_batch": served_batch,
            "served_pick": ref_pick.describe()}


def phase19(ctx: dict) -> dict:
    """Phase 19: the network front door on the card (see the module
    docstring).  Returns the launches of K1's and K6's batch modes behind
    the in-process gateway, each counted from 0 just before its sessions
    and read just after they finished."""
    import signal

    import numpy as np
    import torch

    from tpu_life_torch.backends.base import get_backend, make_runner
    from tpu_life_torch.gateway import Gateway, GatewayConfig, protocol
    from tpu_life_torch.gateway.client import GatewayClient
    from tpu_life_torch.io.codec import encode_board, read_board, read_config
    from tpu_life_torch.kernels import mc_threefry as mct
    from tpu_life_torch.kernels import packed_batch as kb
    from tpu_life_torch.models.rules import get_rule
    from tpu_life_torch.serve import ServeConfig, SimulationService
    from tpu_life_torch.serve.spill_http import read_remote_sessions

    smi, counted, golden = ctx["smi"], ctx["counted"], ctx["golden"]
    t_phase = time.perf_counter()
    conway, ising = get_rule("conway"), get_rule("ising")
    cuda = get_backend("cuda")

    def runner_bytes(board, rule, steps, **kw) -> bytes:
        r = make_runner(cuda, board, rule, **kw)
        r.advance(steps)
        r.sync()
        return np.asarray(r.fetch()).tobytes()

    def golden_bytes(board, what: str) -> None:
        raw = encode_board(board)
        if len(raw) != GOLDEN_BYTES or hashlib.sha256(raw).hexdigest() != GOLDEN_SHA:
            fail(f"{what}: not the golden {GOLDEN_BYTES} bytes, sha256 {GOLDEN_SHA}")

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with gzip.open(FIXTURES / "reference_data.txt.gz", "rb") as f:
            (tmp / "data.txt").write_bytes(f.read())
        shutil.copy(FIXTURES / "reference_grid_size_data.txt", tmp / "grid_size_data.txt")
        h, w, ref_steps = read_config(tmp / "grid_size_data.txt")
        ref_board = read_board(tmp / "data.txt", h, w)

        # (a) an in-process gateway over the cuda service
        svc = SimulationService(ServeConfig(backend="cuda"))
        gw = Gateway(svc, GatewayConfig(port=0))
        gw.start()
        try:
            client = GatewayClient(f"http://127.0.0.1:{gw.port}", retries=8)
            if gw.device_info(wait_s=60.0) != (torch.cuda.device_count(), "cuda"):
                fail(f"phase 19 (a): the gateway reports {gw.device_info()}")
            round_trip_ms = []
            for _ in range(3):  # the first builds the kernels; the others are warm
                t0 = time.perf_counter()
                sid = client.submit(board=ref_board, rule="conway", steps=ref_steps)
                view = client.wait(sid, interval=0.002, timeout=300)
                ref_out = client.result_board(sid)
                round_trip_ms.append((time.perf_counter() - t0) * 1e3)
                if view["state"] != "done":
                    fail(f"phase 19 (a): the reference session ended {view}")
                golden_bytes(ref_out, "phase 19 (a) the reference workload over HTTP")

            rng = np.random.default_rng(19)
            boards = [(rng.random((P19_SIDE, P19_SIDE)) < 0.35).astype(np.int8)
                      for _ in range(P19_SESSIONS)]
            want = [runner_bytes(b, conway, P19_STEPS) for b in boards]
            kb.packed_batch_multi_step.launches = 0
            t0 = time.perf_counter()
            sids = []
            for b in boards:  # staggered: each submit races the pump
                sids.append(client.submit(board=b, rule="conway", steps=P19_STEPS))
                time.sleep(0.002)
            views = [client.wait(s, interval=0.005, timeout=300) for s in sids]
            elapsed = time.perf_counter() - t0
            k1_batch = kb.packed_batch_multi_step.launches
            if any(v["state"] != "done" for v in views):
                fail(f"phase 19 (a): sessions ended {[v['state'] for v in views]}")
            bad = [i for i, s in enumerate(sids) if client.result_board(s).tobytes() != want[i]]
            if bad or k1_batch <= 0:
                fail(f"phase 19 (a): sessions {bad} differ from the cuda Runner; K1's batch "
                     f"mode launched {k1_batch} times")

            spec = protocol.parse_submit({"size": P19_ISING_SIDE, "steps": P19_ISING_STEPS,
                                          "rule": "ising", "seed": P19_ISING_SEED,
                                          "temperature": 2.27})
            want_i = runner_bytes(spec.board, ising, P19_ISING_STEPS, seed=P19_ISING_SEED,
                                  temperature=2.27)
            mct.packed_metropolis_half_batch.launches = 0
            isid = client.submit(size=P19_ISING_SIDE, rule="ising", steps=P19_ISING_STEPS,
                                 seed=P19_ISING_SEED, temperature=2.27)
            iview = client.wait(isid, interval=0.005, timeout=300)
            k6_batch = mct.packed_metropolis_half_batch.launches
            if iview["state"] != "done" or not iview.get("packed") or k6_batch <= 0:
                fail(f"phase 19 (a): ising session {iview}, K6's batch mode launched "
                     f"{k6_batch} times")
            if client.result_board(isid).tobytes() != want_i:
                fail("phase 19 (a): the ising session differs from the cuda Runner")
        finally:
            gw.begin_drain()
            if not gw.wait(timeout=300):
                fail("phase 19 (a): the gateway did not drain")
            gw.close()
        print(f"phase 19 (a), an in-process gateway over the cuda service (card: {smi}): the "
              f"reference workload over HTTP at the golden sha256 three times, round trip ms "
              f"(submit to result, host clock) {round_trip_ms[0]:.1f} with the kernels' build, "
              f"then {round_trip_ms[1]:.1f} and {round_trip_ms[2]:.1f}; {P19_SESSIONS} staggered conway "
              f"{P19_SIDE}^2 x {P19_STEPS} sessions equal to the cuda Runner, "
              f"{P19_SESSIONS / elapsed:.2f} sessions/s ({elapsed:.3f} s), K1's batch mode "
              f"launched {k1_batch} times; ising {P19_ISING_SIDE}^2 x {P19_ISING_STEPS} at T = "
              f"2.27 (packed, {iview.get('lanes')} lanes) equal to the cuda Runner, K6's batch "
              f"mode launched {k6_batch} times", flush=True)

        # (b) spill-store and gateway as child processes
        procs = []

        def start(args: list[str], name: str):
            proc = subprocess.Popen(
                [sys.executable, "-m", "tpu_life_torch", *args], cwd=tmp, env=env,
                stdout=open(tmp / f"{name}.out", "w"), stderr=open(tmp / f"{name}.err", "w"))
            procs.append(proc)
            return proc

        def first_line(proc, name: str, timeout: float = 300.0) -> dict:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                text = (tmp / f"{name}.out").read_text()
                if "\n" in text:
                    return json.loads(text.splitlines()[0])
                if proc.poll() is not None:
                    fail(f"phase 19 (b): {name} exited {proc.returncode}: "
                         f"{(tmp / f'{name}.err').read_text()[-3000:]}")
                time.sleep(0.05)
            fail(f"phase 19 (b): no startup line from {name}")

        def stop(proc, name: str) -> tuple[int, dict]:
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
            return rc, json.loads((tmp / f"{name}.out").read_text().strip().splitlines()[-1])

        try:
            store = start(["spill-store", "--root", str(tmp / "store"), "--port", "0"], "store")
            surl = first_line(store, "store")["url"]
            t0 = time.perf_counter()
            gw_a = start(["gateway", "--port", "0", "--serve-backend", "cuda", "--spill-url",
                          surl, "--metrics-file", str(tmp / "m.jsonl")], "gw_a")
            a = first_line(gw_a, "gw_a")
            startup_s = time.perf_counter() - t0
            if a.get("device_kind") != "cuda" or a.get("backend") != "cuda":
                fail(f"phase 19 (b): the gateway's startup line {a}")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "tpu_life_torch", "client", "submit", "--url", a["url"],
                 "--input-file", "data.txt", "--steps", str(ref_steps), "--wait",
                 "--output-file", str(tmp / "via_client.txt")],
                cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
            client_s = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"phase 19 (b): client submit exited {proc.returncode}: {proc.stderr[-2000:]}")
            golden(tmp / "via_client.txt", "phase 19 (b) client submit through the gateway")

            kill_board = protocol.parse_submit({"size": P19_KILL_SIDE, "steps": P19_KILL_STEPS,
                                                "seed": P19_KILL_SEED}).board
            ca = GatewayClient(a["url"], retries=4)
            ksid = ca.submit(size=P19_KILL_SIDE, steps=P19_KILL_STEPS, seed=P19_KILL_SEED)
            deadline, records = time.monotonic() + 300, []
            while time.monotonic() < deadline:
                v = ca.poll(ksid)
                if v["finished"]:
                    fail(f"phase 19 (b): the session finished before the kill: {v}")
                if v["steps_done"] > 0:
                    records = read_remote_sessions(surl, a["run_id"])[0]
                    if records:
                        break
                time.sleep(0.02)
            gw_a.kill()  # SIGKILL: no drain, no flush
            gw_a.wait(timeout=60)
            killed_at = v["steps_done"]
            records, corrupt, disabled = read_remote_sessions(surl, a["run_id"])
            rec = {r.sid: r for r in records}.get(ksid)
            if rec is None or corrupt or disabled or not 0 < rec.step < P19_KILL_STEPS:
                fail(f"phase 19 (b): the rescue read {records}, corrupt {corrupt}, "
                     f"disabled {disabled}")
            fresh = SimulationService(ServeConfig(backend="cuda"))
            try:
                t0 = time.perf_counter()
                rsid = fresh.submit(rec.board, rec.rule, rec.steps_total - rec.step,
                                    start_step=rec.step)
                fresh.drain()
                resume_s = time.perf_counter() - t0
                resumed = fresh.result(rsid)
            finally:
                fresh.close()
            if resumed.tobytes() != runner_bytes(kill_board, conway, P19_KILL_STEPS):
                fail("phase 19 (b): the resumed session differs from the uninterrupted Runner")

            gw_b = start(["gateway", "--port", "0", "--serve-backend", "cuda"], "gw_b")
            b = first_line(gw_b, "gw_b")
            cb = GatewayClient(b["url"], retries=4)
            bsid = cb.submit(size=64, steps=32, seed=3)
            if cb.wait(bsid, timeout=300)["state"] != "done":
                fail("phase 19 (b): the second gateway's session did not finish")
            rc, summary = stop(gw_b, "gw_b")
            if rc != 0 or summary.get("mode") != "gateway" or summary.get("done") != 1 or \
                    summary.get("pump_error") is not None:
                fail(f"phase 19 (b): the second gateway's SIGTERM: exit {rc}, {summary}")
            print(f"phase 19 (b), child processes: spill-store and gateway --serve-backend cuda "
                  f"--spill-url (startup line in {startup_s:.1f} s, device_kind "
                  f"{a['device_kind']}, devices {a.get('devices')}); client submit of the "
                  f"reference workload at the golden sha256 ({client_s:.2f} s, a child); conway "
                  f"{P19_KILL_SIDE}^2 x {P19_KILL_STEPS} killed with SIGKILL at step {killed_at}, "
                  f"rescued at step {rec.step} from the HTTP store and resumed in a fresh cuda "
                  f"service ({resume_s:.2f} s), equal to the uninterrupted Runner; a second "
                  f"gateway exited 0 on SIGTERM ({summary['done']} done, pump {summary['pump']})",
                  flush=True)

            # (c) stats on the killed gateway's sink, torch-free
            proc = subprocess.run(
                [sys.executable, "-m", "tpu_life_torch", "stats", "--json", str(tmp / "m.jsonl")],
                cwd=tmp, env=env, capture_output=True, text=True, timeout=120)
            if proc.returncode != 0:
                fail(f"phase 19 (c): stats exited {proc.returncode}: {proc.stderr[-2000:]}")
            serve = json.loads(proc.stdout).get("serve", {})
            need = {"rounds", "sessions_done", "sessions_per_sec", "batch_occupancy_mean",
                    "pump", "device_idle_fraction", "steps_advanced"}
            if not need <= set(serve) or serve["sessions_done"] < 1:
                fail(f"phase 19 (c): stats --json has serve {serve}")
            no_demotion("phase 19 (b): the gateways", ctx["watch"], proc.stdout,
                        *((tmp / f"{name}.err").read_text() for name in ("gw_a", "gw_b")))
            rc, _ = stop(store, "store")
            if rc != 0:
                fail(f"phase 19 (b): the spill store exited {rc} on SIGTERM")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=60)
        print(f"phase 19 (c), stats --json on the killed gateway's sink: {serve['rounds']} "
              f"rounds, {serve['sessions_done']} sessions done, pump {serve['pump']}, device "
              f"idle fraction {serve['device_idle_fraction']}", flush=True)

        # (d) the host backends
        files = ["--config-file", str(tmp / "grid_size_data.txt"), "--input-file",
                 str(tmp / "data.txt")]
        for args in (["--backend", "native"], ["--backend", "stripes", "--num-devices", "4"]):
            out = tmp / "host.txt"
            counted(["run", *args, *files, "--output-file", str(out)], f"run {' '.join(args)}")
            golden(out, f"phase 19 (d) run {' '.join(args)}")
        spool = tmp / "spool.jsonl"
        counted(["submit", *files, "--requests", str(spool), "--output-file",
                 str(tmp / "served.txt")], "submit the reference workload")
        counted(["serve", "--serve-backend", "native", "--requests", str(spool), "--output-dir",
                 str(tmp / "serve_out")], "serve --serve-backend native")
        golden(tmp / "served.txt", "phase 19 (d) serve --serve-backend native")
        big = ["--config-file", str(tmp / "big_grid.txt"), "--input-file", str(tmp / "big.txt")]
        counted(["gen", "--height", str(P19_NATIVE_SIDE), "--width", str(P19_NATIVE_SIDE),
                 "--steps", str(P19_NATIVE_STEPS), "--seed", "7", *big], "gen")
        lines, _, _ = counted(["run", "--backend", "native", *big, "--output-file",
                               str(tmp / "native.txt")], "run --backend native 4096^2")
        total = [ln.split("=")[1].strip() for ln in lines if ln.startswith("Total time = ")]
        counted(["run", "--backend", "cuda", *big, "--output-file", str(tmp / "cuda.txt")],
                "run --backend cuda 4096^2")
        if len(total) != 1 or (tmp / "native.txt").read_bytes() != (tmp / "cuda.txt").read_bytes():
            fail(f"phase 19 (d): run --backend native at {P19_NATIVE_SIDE}^2: Total lines "
                 f"{total}, or its output differs from the cuda run's")
    print(f"phase 19 (d), the host backends: run --backend native and --backend stripes "
          f"--num-devices 4 and serve --serve-backend native at the golden sha256; run --backend "
          f"native {P19_NATIVE_SIDE}^2 x {P19_NATIVE_STEPS}: Total time = {total[0]} s on the "
          f"card machine's host CPUs ({os.cpu_count()} CPUs; the card idle), equal to the cuda "
          f"run's bytes; phase 19 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"k1_batch": k1_batch, "k6_batch": k6_batch}


def _worker_pids(spill_root: Path) -> dict[str, tuple[int, int]]:
    """``{worker: (generation, pid)}`` of the live gateway workers of the
    fleet whose spill root is ``spill_root``: each worker's argv names its
    per-incarnation spill directory ``<root>/<name>g<generation>``."""
    found = {}
    for pid_dir in Path("/proc").iterdir():
        if not pid_dir.name.isdigit():
            continue
        try:
            argv = (pid_dir / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        if b"gateway" not in argv or b"--spill-dir" not in argv:
            continue
        m = re.fullmatch(re.escape(str(spill_root)) + r"/(w\d+)g(\d+)",
                         argv[argv.index(b"--spill-dir") + 1].decode())
        if m:
            gen = int(m.group(2))
            if found.get(m.group(1), (-1, 0))[0] < gen:
                found[m.group(1)] = (gen, int(pid_dir.name))
    return found


def _holds_the_card(pid: int) -> bool:
    """Whether process ``pid`` has a ``/dev/nvidia*`` device open."""
    try:
        return any(os.readlink(fd).startswith("/dev/nvidia")
                   for fd in Path(f"/proc/{pid}/fd").iterdir())
    except OSError:
        return False


def _prom_by_worker(text: str, name: str, **labels) -> dict[str, float]:
    """``{worker: value}`` of one family's samples in the router's merged
    exposition, optionally filtered by other labels."""
    out = {}
    for line in text.splitlines():
        if not line.startswith(name + "{"):
            continue
        head, _, value = line.rpartition(" ")
        got = dict(re.findall(r'(\w+)="([^"]*)"', head))
        if "worker" in got and all(got.get(k) == v for k, v in labels.items()):
            out[got["worker"]] = out.get(got["worker"], 0.0) + float(value)
    return out


def phase20(ctx: dict) -> dict:
    """Phase 20: the fleet on the card (see the module docstring).  Returns
    the workers that built the cuda Conway engine (K1's batch mode) and the
    packed steps (K6's batch mode) each worker ran, read from the router's
    merged /metrics: the kernels ran in the workers' processes, so their
    launch counters are not this process's."""
    import signal
    import urllib.request

    import numpy as np

    from tpu_life_torch import chaos
    from tpu_life_torch.backends.base import get_backend, make_runner
    from tpu_life_torch.chaos.drill import DEFAULT_POINTS
    from tpu_life_torch.gateway import protocol
    from tpu_life_torch.gateway.client import GatewayClient, GatewayError
    from tpu_life_torch.mc.engine import MCHostRunner
    from tpu_life_torch.models.rules import get_rule

    smi = ctx["smi"]
    t_phase = time.perf_counter()
    conway, ising = get_rule("conway"), get_rule("ising")
    cuda = get_backend("cuda")

    def runner_bytes(board, steps) -> bytes:
        r = make_runner(cuda, board, conway)
        r.advance(steps)
        r.sync()
        return np.asarray(r.fetch()).tobytes()

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        spill, trace = tmp / "spill", tmp / "trace"

        def child(args: list[str], name: str):
            proc = subprocess.Popen(
                [sys.executable, "-m", "tpu_life_torch", *args], cwd=tmp, env=env,
                stdout=open(tmp / f"{name}.out", "w"), stderr=open(tmp / f"{name}.err", "w"))
            procs.append(proc)
            return proc

        def tool(args: list[str], what: str, rc: int = 0) -> str:
            proc = subprocess.run([sys.executable, "-m", "tpu_life_torch", *args], cwd=tmp,
                                  env=env, capture_output=True, text=True, timeout=300)
            if proc.returncode != rc:
                fail(f"phase 20: {what} exited {proc.returncode}: {proc.stderr[-2000:]}")
            return proc.stdout

        try:
            # (a) the fleet with its defaults: workers on the card
            t0 = time.perf_counter()
            fleet = child(["fleet", "--workers", "2", "--port", "0", "--spill-dir", str(spill),
                           "--trace-dir", str(trace), "--log-dir", str(tmp / "logs")], "fleet")
            deadline = time.monotonic() + 300
            while "\n" not in (tmp / "fleet.out").read_text():
                if fleet.poll() is not None or time.monotonic() > deadline:
                    fail(f"phase 20 (a): no startup line from the fleet: "
                         f"{(tmp / 'fleet.err').read_text()[-3000:]}")
                time.sleep(0.05)
            start = json.loads((tmp / "fleet.out").read_text().splitlines()[0])
            url = start["url"]
            if start.get("backend") != "cuda" or start.get("workers") != 2:
                fail(f"phase 20 (a): the fleet's startup line {start}")
            while True:
                try:
                    with urllib.request.urlopen(url + "/readyz", timeout=2) as r:
                        if json.load(r).get("workers_ready") == 2:
                            break
                except OSError:
                    pass
                if fleet.poll() is not None or time.monotonic() > deadline:
                    fail(f"phase 20 (a): the fleet never had 2 ready workers: "
                         f"{(tmp / 'fleet.err').read_text()[-3000:]}")
                time.sleep(0.1)
            ready_s = time.perf_counter() - t0
            pids = _worker_pids(spill)
            if sorted(pids) != ["w0", "w1"]:
                fail(f"phase 20 (a): the workers' processes {pids}")
            listed = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.split()
            listed = {int(p) for p in listed if p.strip().isdigit()}
            ours = {pid for _, pid in pids.values()}
            if ours <= listed:
                held = "each worker's pid among nvidia-smi --query-compute-apps"
            elif listed & ours or not all(_holds_the_card(pid) for pid in ours):
                fail(f"phase 20 (a): workers {pids}, nvidia-smi compute apps {sorted(listed)}")
            else:
                held = (f"nvidia-smi lists pids {sorted(listed)} of another pid namespace; "
                        f"each worker has /dev/nvidia* open")
            client = GatewayClient(url, retries=8)
            boards = [protocol.parse_submit({"size": P20_SIDE, "steps": P20_STEPS, "seed": 500 + i})
                      .board for i in range(P20_SESSIONS)]
            spins = [protocol.parse_submit({"size": P20_SIDE, "steps": P20_STEPS, "rule": "ising",
                                            "seed": 600 + i, "temperature": 2.27}).board
                     for i in range(P20_ISING)]
            conway_want = [runner_bytes(b, P20_STEPS) for b in boards]
            ising_want = []
            for j, b in enumerate(spins):
                oracle = MCHostRunner(b, ising, seed=600 + j, temperature=2.27)
                oracle.advance(P20_STEPS)
                ising_want.append(oracle.board.tobytes())
            rates = []
            for _ in range(2):  # a first wave meets fresh worker processes
                t0 = time.perf_counter()
                sids = []
                for i, board in enumerate(boards):
                    sids.append(client.submit(board=board, rule="conway", steps=P20_STEPS))
                    if i == P20_SESSIONS // 2:
                        isids = [client.submit(board=b, rule="ising", steps=P20_STEPS,
                                               seed=600 + j, temperature=2.27)
                                 for j, b in enumerate(spins)]
                    time.sleep(0.01)  # staggered arrivals
                views = [client.wait(s, timeout=300) for s in [*sids, *isids]]
                rates.append((P20_SESSIONS + P20_ISING) / (time.perf_counter() - t0))
                if any(v["state"] != "done" for v in views):
                    fail(f"phase 20 (a): sessions ended {[v['state'] for v in views]}")
                bad = [s for s, want in zip([*sids, *isids], [*conway_want, *ising_want])
                       if client.result_board(s).tobytes() != want]
                if bad:
                    fail(f"phase 20 (a): sessions {bad} differ from their oracles")
            per_worker = {w: sum(1 for s in sids if s.startswith(w + "g")) for w in ("w0", "w1")}
            ising_workers = {s.split("g")[0] for s in isids}
            metrics = client.metrics()
            built = _prom_by_worker(metrics, "serve_engine_compile_count",
                                    compile_key=f"B3/S23:{P20_SIDE}x{P20_SIDE}:cuda")
            steps = _prom_by_worker(metrics, "serve_steps_total")
            packed = _prom_by_worker(metrics, "serve_packed_steps_total")
            no_demotion("phase 20 (a): the workers", ctx["watch"], metrics)
            if min(per_worker.values()) < 1 or sorted(built) != ["w0", "w1"] or \
                    min(steps.values()) <= 0 or any(packed.get(w, 0) <= 0 for w in ising_workers):
                fail(f"phase 20 (a): sessions a worker {per_worker}, the cuda Conway engine built "
                     f"{built}, steps {steps}, packed steps {packed} (ising on {ising_workers})")
            print(f"phase 20 (a), fleet --workers 2 (card: {smi}): both workers ready "
                  f"{ready_s:.1f} s after the fleet's start, {held}; "
                  f"{P20_SESSIONS} staggered conway {P20_SIDE}^2 x {P20_STEPS} sessions "
                  f"({per_worker} a worker) equal to the cuda Runner and {P20_ISING} ising at "
                  f"T = 2.27 (on {sorted(ising_workers)}) equal to MCHostRunner, "
                  f"{rates[0]:.2f} sessions/s through the router, a second wave "
                  f"{rates[1]:.2f}; the cuda Conway engine (K1's "
                  f"batch mode) built on {sorted(built)}, steps {steps}, packed steps "
                  f"(K6's batch mode) {packed}", flush=True)

            # (b) failover: SIGKILL the worker holding a long session
            kill_board = protocol.parse_submit({"size": P20_KILL_SIDE, "steps": P20_KILL_STEPS,
                                                "seed": P20_KILL_SEED}).board
            ksid = client.submit(size=P20_KILL_SIDE, steps=P20_KILL_STEPS, seed=P20_KILL_SEED)
            victim = client.poll(ksid)["worker"]
            gen0, vpid = pids[victim]
            spilled = spill / f"{victim}g{gen0}" / ksid.split("-", 1)[1]
            deadline = time.monotonic() + 120
            while not any(spilled.glob("board_*")):
                v = client.poll(ksid)
                if v["finished"] or time.monotonic() > deadline:
                    fail(f"phase 20 (b): no spill of {ksid} before the kill: {v}")
                time.sleep(0.02)
            # three monitor ticks: the supervisor's scrape has the victim's
            # spans in the capture before the kill
            time.sleep(0.75)
            v = client.poll(ksid)
            if v["finished"]:
                fail(f"phase 20 (b): {ksid} finished before the kill: {v}")
            killed_at = v["steps_done"]
            t_kill = time.perf_counter()
            os.kill(vpid, signal.SIGKILL)
            resumed_s = None
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                try:
                    v = client.poll(ksid)
                except GatewayError as e:
                    # a poll cut by the kill (502) or answered while the
                    # rescue runs (409 migrating): the client's recourse
                    # is to poll again
                    if e.status not in (409, 502, 503):
                        raise
                    time.sleep(0.02)
                    continue
                if v.get("worker") not in (None, victim) and v["state"] in ("running", "done"):
                    resumed_s = time.perf_counter() - t_kill
                    break
                time.sleep(0.02)
            if resumed_s is None:
                fail(f"phase 20 (b): {ksid} was not resumed on the survivor: {v}")
            survivor = v["worker"]
            deadline = time.monotonic() + 120
            while True:
                respawned = _worker_pids(spill).get(victim, (gen0, vpid))
                if respawned[0] > gen0:
                    break
                if time.monotonic() > deadline:
                    fail(f"phase 20 (b): {victim} was not respawned")
                time.sleep(0.1)
            while True:
                with urllib.request.urlopen(url + "/readyz", timeout=5) as r:
                    if json.load(r).get("workers_ready") == 2:
                        break
                if time.monotonic() > deadline:
                    fail(f"phase 20 (b): the respawned {victim} never became ready")
                time.sleep(0.1)
            rejoined_s = time.perf_counter() - t_kill
            view = client.wait(ksid, timeout=300)
            if view["state"] != "done" or \
                    client.result_board(ksid).tobytes() != runner_bytes(kill_board, P20_KILL_STEPS):
                fail(f"phase 20 (b): the migrated session {view} differs from the "
                     f"uninterrupted Runner")
            print(f"phase 20 (b), failover: conway {P20_KILL_SIDE}^2 x {P20_KILL_STEPS} on "
                  f"{victim} SIGKILLed at step {killed_at}, resumed on {survivor} "
                  f"{resumed_s:.2f} s after the kill, equal to the uninterrupted Runner; "
                  f"{victim} respawned as generation {respawned[0]} and ready "
                  f"{rejoined_s:.1f} s after the kill", flush=True)

            # (c) the console, the drain and the offline tools
            top = json.loads(tool(["top", "--once", "--json", "--url", url, "--interval", "0.5"],
                                  "top --once --json"))
            if not {"w0", "w1"} <= set(top["workers"]):
                fail(f"phase 20 (c): top names the workers {sorted(top['workers'])}")
            fleet.send_signal(signal.SIGTERM)
            rc = fleet.wait(timeout=300)
            summary = json.loads((tmp / "fleet.out").read_text().strip().splitlines()[-1])
            if rc != 0 or summary.get("failed_workers") != [] or \
                    summary.get("migrations", {}).get("migrated", 0) < 1:
                fail(f"phase 20 (c): the fleet's SIGTERM: exit {rc}, {summary}")
            merged = json.loads(tool(["trace", "merge", str(trace)], "trace merge"))
            report = json.loads(tool(["doctor", str(trace), "--sid", ksid, "--json"],
                                     f"doctor --sid {ksid}"))
            kinds = {f["kind"] for f in report["findings"]}
            if not {"worker_exit", "migration"} <= kinds or report["outcome"] != "done":
                fail(f"phase 20 (c): doctor --sid {ksid}: {report}")
            tool(["doctor", str(trace), "--slo"], "doctor --slo")
            tool(["doctor", str(trace), "--scale"], "doctor --scale")
            print(f"phase 20 (c), top --once --json named {sorted(top['workers'])}; SIGTERM "
                  f"drained the fleet to exit 0 (generations {summary['generations']}, "
                  f"migrations {summary['migrations']}); trace merge: {merged['events']} events "
                  f"of {merged['incarnations']} incarnations; doctor --sid {ksid}: "
                  f"{sorted(kinds)}, outcome {report['outcome']}; doctor --slo and --scale "
                  f"exit 0", flush=True)

            # (d) the chaos drill on cuda workers
            t0 = time.perf_counter()
            out = tool(["chaos", "--seed", "7", "--workers", "2", "--sessions", "4",
                        "--ising-sessions", "1", "--workdir", str(tmp / "drill")], "chaos")
            drill_s = time.perf_counter() - t0
            drill = json.loads(out.strip().splitlines()[-1])
            no_demotion("phase 20 (d): the drill's workers", ctx["watch"],
                        *(p.read_text() for p in (tmp / "drill").glob("**/*.log")))
            bad = [k for k, v in drill["invariants"].items() if not v["ok"]]
            if not drill["ok"] or bad or drill["delivered"] != drill["sessions"] or \
                    drill["plan_digest"] != chaos.ChaosPlan(7, DEFAULT_POINTS).digest():
                fail(f"phase 20 (d): the drill: ok {drill['ok']}, broken {bad}, delivered "
                     f"{drill['delivered']} of {drill['sessions']}, digest "
                     f"{drill['plan_digest']}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=60)
            for _, pid in _worker_pids(spill).values():
                with contextlib.suppress(OSError):
                    os.kill(pid, signal.SIGKILL)
    print(f"phase 20 (d), chaos --seed 7 on cuda workers: ok, {len(drill['invariants'])} "
          f"invariants, {drill['delivered']} of {drill['sessions']} sessions delivered, "
          f"kills {drill['kills']}, injections {drill['injections']}, digest "
          f"{drill['plan_digest']} ({drill_s:.1f} s); phase 20 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"k1_batch_workers": sorted(built), "k6_packed_steps": packed}

# phase 21's child: one cuda service under the pipelined pump with a K1
# batch-mode key and a route-ops key; the card is left short of memory once
# a chunk of the ops key is in flight, until the ladder demotes that key.
# ``_run_chunk`` is wrapped to record each fault where it is raised (type,
# first line, free bytes, the in-flight accounting) and raise it on
P21_CHILD = """
import json, sys, time
from pathlib import Path
import numpy as np
import torch
from tpu_life_torch.kernels import packed_batch as kb
from tpu_life_torch.serve import ServeConfig, SimulationService
from tpu_life_torch.serve.engine import BatchEngine

tmp = Path(sys.argv[1])
steps, n, ops_side, ops_steps, n_ops, chunk, margin = map(int, sys.argv[2:9])
conway = [np.load(tmp / f"c{i}.npy") for i in range(n)]
ops = [np.load(tmp / f"t{i}.npy") for i in range(n_ops)]
faults = []
run_chunk = BatchEngine._run_chunk

def probe(self, boards):
    try:
        return run_chunk(self, boards)
    except BaseException as e:
        text = str(e)
        faults.append({"type": type(e).__name__,
                       "oom": isinstance(e, torch.cuda.OutOfMemoryError),
                       "first_line": text.splitlines()[0] if text else "",
                       "free_bytes": torch.cuda.mem_get_info(self.device)[0],
                       "inflight": {str(k): v for k, v in self._inflight.items()},
                       "route": self.route, "chunk_steps": self.chunk_steps})
        raise

BatchEngine._run_chunk = probe
svc = SimulationService(ServeConfig(backend="cuda", capacity=8, chunk_steps=chunk))
assert svc.config.pipeline
ballast = []

def squeeze():
    # the caching allocator would hand a chunk the blocks an earlier chunk
    # freed: empty it, then leave the card ``margin`` free bytes
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    while free > margin:
        try:
            ballast.append(torch.empty(free - margin, dtype=torch.uint8, device="cuda"))
        except torch.cuda.OutOfMemoryError:
            free -= 16 << 20
            continue
        free = torch.cuda.mem_get_info()[0]

def ops_engine():
    return next((e for k, e in svc.scheduler.engines.items()
                 if k.shape == (ops_side, ops_side)), None)

def ops_done():
    return sum(svc.poll(s).steps_done for s in osids)

def pump_until(cond, what, limit=400):
    for _ in range(limit):
        if cond():
            return
        svc.pump()
    raise SystemExit(f"never {what}")

t_phase = time.perf_counter()
kb.packed_batch_multi_step.launches = 0
sids = [svc.submit(b, "conway", steps) for b in conway]
osids = [svc.submit(b, "conway:T", ops_steps) for b in ops]
# the card: the ops key's board-steps between two synchronized points,
# its first chunk done and its second
pump_until(lambda: ops_engine() is not None and ops_engine().chunks >= 1, "dispatched")
torch.cuda.synchronize()
t_a, s_a = time.perf_counter(), ops_done()
pump_until(lambda: ops_engine().chunks >= 2, "dispatched a second chunk")
torch.cuda.synchronize()
card_rate = (ops_done() - s_a) / (time.perf_counter() - t_a)
# a third chunk in flight, then the card left short
pump_until(lambda: ops_engine().chunks >= 3 and ops_engine().inflight, "in flight")
inflight_before = {str(k): v for k, v in ops_engine()._inflight.items()}
launches_before = kb.packed_batch_multi_step.launches
squeeze()
rounds = 0
while not svc.scheduler.demoted and rounds < 20:
    svc.pump()
    rounds += 1
    squeeze()
squeezed_launches = kb.packed_batch_multi_step.launches - launches_before
ballast.clear()
torch.cuda.empty_cache()
host = ops_engine()
(ops_key,) = svc.scheduler.demoted
card_steps = [s.steps_done - host._inflight.get(slot, 0)
              for slot, s in svc.scheduler.running[ops_key].items()]
t_h = time.perf_counter()
while not all(svc.poll(s).finished for s in osids):
    svc.pump()
host_s = time.perf_counter() - t_h
svc.drain(max_rounds=400)
views = [svc.poll(s) for s in [*sids, *osids]]
for i, s in enumerate(sids):
    np.save(tmp / f"c{i}_out.npy", svc.result(s))
for i, s in enumerate(osids):
    np.save(tmp / f"t{i}_out.npy", svc.result(s))
engines = {f"{k.shape[0]}x{k.shape[1]}":
           [type(e).__name__, getattr(e, "route", None), e.chunk_steps]
           for k, e in svc.scheduler.engines.items()}
stats = svc.stats()
svc.close()
print("P21 " + json.dumps({
    "faults": faults, "inflight_before": inflight_before,
    "recoveries": stats["engine_recoveries"],
    "demoted": [f"{k.shape[0]}x{k.shape[1]}" for k in svc.scheduler.demoted],
    "engines": engines, "states": [v.state.value for v in views],
    "degraded": [v.degraded_reason for v in views],
    "k1_batch": kb.packed_batch_multi_step.launches, "k1_batch_squeezed": squeezed_launches,
    "squeeze_rounds": rounds, "card_rate": card_rate,
    "host_rate": sum(ops_steps - c for c in card_steps) / host_s, "card_steps": card_steps,
    "seconds": time.perf_counter() - t_phase}), flush=True)
"""


def phase21(ctx: dict) -> dict:
    """Phase 21: serving recovery on the card (see the module docstring).
    Returns the launches of K1's batch mode in the phase's child, counted
    from 0 just before its sessions and read after they finished."""
    import numpy as np

    from tpu_life_torch.models.rules import get_rule
    from tpu_life_torch.ops.reference import run_np

    smi = ctx["smi"]
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        conway = [np.random.default_rng(2100 + i).integers(0, 2, (P21_SIDE, P21_SIDE))
                  .astype(np.int8) for i in range(P21_SESSIONS)]
        ops = [np.random.default_rng(2200 + i).integers(0, 2, (P21_OPS_SIDE, P21_OPS_SIDE))
               .astype(np.int8) for i in range(P21_OPS_SESSIONS)]
        for name, boards in (("c", conway), ("t", ops)):
            for i, b in enumerate(boards):
                np.save(tmp / f"{name}{i}.npy", b)
        proc = subprocess.Popen(
            [sys.executable, "-c", P21_CHILD, str(tmp), *map(str, (
                P21_STEPS, P21_SESSIONS, P21_OPS_SIDE, P21_OPS_STEPS, P21_OPS_SESSIONS,
                P21_CHUNK, P21_MARGIN))],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        # the numpy oracle meanwhile, a board a thread
        with ThreadPoolExecutor(len(conway) + len(ops)) as pool:
            want = list(pool.map(lambda a: run_np(*a), [
                *((b, get_rule("conway"), P21_STEPS) for b in conway),
                *((b, get_rule("conway:T"), P21_OPS_STEPS) for b in ops)]))
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        if proc.returncode != 0:
            fail(f"phase 21: the child exited {proc.returncode}: {err[-3000:]}")
        rec = json.loads([ln for ln in out.splitlines() if ln.startswith("P21 ")][-1][4:])
        got = [np.load(tmp / f"c{i}_out.npy") for i in range(P21_SESSIONS)]
        got += [np.load(tmp / f"t{i}_out.npy") for i in range(P21_OPS_SESSIONS)]
        differ = [i for i, (g, w) in enumerate(zip(got, want)) if g.tobytes() != w.tobytes()]
    faults = rec["faults"]
    ops_key, k1_key = f"{P21_OPS_SIDE}x{P21_OPS_SIDE}", f"{P21_SIDE}x{P21_SIDE}"
    n = P21_SESSIONS
    if len(faults) != 2 or not all(f["oom"] and f["route"] == "ops" for f in faults) or \
            not faults[0]["inflight"] or faults[1]["chunk_steps"] != P21_CHUNK // 2:
        fail(f"phase 21: want two real torch.OutOfMemoryError from the ops key's _run_chunk, "
             f"the first with a chunk in flight, the second at the halved chunk: {faults}")
    if rec["recoveries"] != {"oom_halved_chunk": 1, "oom_host_demoted": 1} or \
            rec["demoted"] != [ops_key] or rec["engines"].get(k1_key) != \
            ["BatchEngine", "k1_batch", P21_CHUNK] or \
            rec["engines"].get(ops_key, [None])[0] != "HostBatchEngine":
        fail(f"phase 21: recoveries {rec['recoveries']}, demoted {rec['demoted']}, engines "
             f"{rec['engines']}")
    if rec["states"] != ["done"] * (n + P21_OPS_SESSIONS) or \
            rec["degraded"] != [None] * n + ["oom_host_demoted"] * P21_OPS_SESSIONS:
        fail(f"phase 21: states {rec['states']}, degraded_reason {rec['degraded']}")
    if differ:
        fail(f"phase 21: sessions {differ} differ from the numpy oracle's bytes")
    if rec["k1_batch"] <= 0 or rec["k1_batch_squeezed"] <= 0:
        fail(f"phase 21: K1's batch mode launched {rec['k1_batch']} times, "
             f"{rec['k1_batch_squeezed']} while the card was short")
    for i, f in enumerate(faults):
        print(f"phase 21 fault {i + 1} (card: {smi}): {f['type']} from BatchEngine._run_chunk "
              f"(route {f['route']}, chunk {f['chunk_steps']}): {f['first_line']!r}; free bytes "
              f"at the fault {f['free_bytes']}; in-flight accounting {f['inflight']}", flush=True)
    print(f"phase 21 (card: {smi}): one cuda service, pipelined pump, capacity 8, chunk "
          f"{P21_CHUNK}: {n} conway {P21_SIDE}^2 x {P21_STEPS} (route k1_batch) beside "
          f"{P21_OPS_SESSIONS} conway:T {P21_OPS_SIDE}^2 x {P21_OPS_STEPS} (route ops); the "
          f"card left {P21_MARGIN} free bytes from when the ops key's chunk "
          f"{rec['inflight_before']} was in flight; engine_recoveries {rec['recoveries']}; "
          f"degraded_reason {rec['degraded']}; every session equal to the numpy oracle's bytes; "
          f"the conway key stayed on K1's batch mode ({rec['k1_batch']} launches in the phase, "
          f"{rec['k1_batch_squeezed']} in the {rec['squeeze_rounds']} rounds the card was "
          f"short); the ops key {rec['card_rate']:.1f} board-steps/s on the card before the "
          f"demotion (host clock between two synchronized points), {rec['host_rate']:.2f} on "
          f"the host after it (from step {rec['card_steps']}); child {rec['seconds']:.1f} s, "
          f"phase 21 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"k1_batch": rec["k1_batch"]}


def cli_main_rc(args: list[str]) -> int:
    """The exit code of one in-process CLI call, its output discarded."""
    from tpu_life_torch import cli

    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        return cli.main(args)

if __name__ == "__main__":
    raise SystemExit(main())
